"""The comparison that decides ``correct`` fails a broken timed path and the
control.

Each test drives a whole run on the CPU (the harness's look for a card
skipped, the sizes a test holds) with the program broken underneath in one
way a cell can be broken: an answer altered where it is produced, or half
of the batch left out. The cells carry no state from step to step and run
on one chip, so a state left unchanged and a skipped exchange between
chips are not among them. The control, the plain reference one precision
lower (bfloat16) in the program's place, must fail too.
"""

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.conftest import TINY


def run(cell):
    return harness.run_cell(cell, 2 ** 33 + 17, 0.2, False, t_start=0.0,
                            device="cpu",
                            config_override=TINY[cell.split(".")[0]])


class _HalfRays(torch.autograd.Function):
    """Identity forward; the backward keeps the cotangent of the first half
    of the image's rows only, doubled: the loss's mean taken over the rays
    that are left."""

    @staticmethod
    def forward(ctx, img):
        return img.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        h = g.shape[0] // 2
        g[:h] *= 2.0
        g[h:] = 0.0
        return g


def _broken_fit(monkeypatch, fault):
    from vrdd_tpu_torch.kernels import slice_vjp

    real = slice_vjp.pallas_hist_render_diff

    def broken(*args, **kw):
        img = real(*args, **kw)
        if fault == "answer":
            bump = torch.zeros_like(img)
            bump[img.shape[0] // 2, img.shape[1] // 3, 1] = 0.05
            return img + bump
        return _HalfRays.apply(img)

    monkeypatch.setattr(slice_vjp, "pallas_hist_render_diff", broken)


def _broken_frames(monkeypatch, fault):
    from vrdd_tpu_torch.models import pipeline

    real = pipeline.RenderPipeline.render

    def broken(self, *args, **kw):
        img = real(self, *args, **kw).clone()
        if fault == "answer":
            img[img.shape[0] // 3, img.shape[1] // 2, 0] ^= 0x80
        else:
            img[img.shape[0] // 2:] = 0
        return img

    monkeypatch.setattr(pipeline.RenderPipeline, "render", broken)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
@pytest.mark.parametrize("cell", ["fit512_b16.mean", "fit512_b16.entropy"])
def test_broken_fit_step_is_not_correct(cell, fault, monkeypatch):
    assert run(cell)["correct"]
    _broken_fit(monkeypatch, fault)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
@pytest.mark.parametrize("cell", ["isabel_b32.axis", "isabel_b32.orbit"])
def test_broken_frame_is_not_correct(cell, fault, monkeypatch, card_dispatch):
    assert run(cell)["correct"]
    _broken_frames(monkeypatch, fault)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["fit512_b16.mean", "fit512_b16.entropy",
                                  "isabel_b32.axis", "isabel_b32.orbit"])
def test_control_is_not_correct(cell, card_dispatch):
    """The control's readings pass some limit of the cell; the program's
    stay under every one."""
    readings = calibrate.calibrate(cell, [9], 0.2, device="cpu",
                                   config_override=TINY[cell.split(".")[0]],
                                   out=lambda line: None)
    limits = harness.load_config(cell)["limits"]
    assert all(readings[k][0] <= lim for k, lim in limits.items())
    assert any(readings[k][1] > lim for k, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fit512_b16.mean", "isabel_b32.axis",
                                  "fit512_b16.entropy", "isabel_b32.orbit"])
def test_control_fails_at_the_cells_own_size(cell, card):
    """On the card, at the cell's own sizes, over three seeds: the program
    passes every limit, the control fails one on every seed."""
    limits = harness.load_config(cell)["limits"]
    for seed in (2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7):
        readings = calibrate.calibrate(cell, [seed], 1.0,
                                       out=lambda line: None)
        assert all(readings[k][0] <= lim for k, lim in limits.items())
        assert any(readings[k][1] > lim for k, lim in limits.items())
