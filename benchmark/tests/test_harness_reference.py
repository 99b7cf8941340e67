"""The plain reference agrees with the program's plain path at a tiny size
on the CPU, and imports nothing of the program or of JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import imports, inputs
from benchmark.reference import sweep as ref
from benchmark.tests.conftest import ROOT


# float32 roundings in other orders (the program resamples by matmuls of
# dense weights, sums the LUT's tent basis); the variance also cancels (C2
# - 2 m C1 + m^2 C0 of terms 30x the result), times the TF's scale
@pytest.mark.parametrize("stat,tol", [("mean", 1e-5), ("var", 1e-4),
                                      ("entropy", 1e-5)])
def test_fit_step_matches_the_program(stat, tol):
    from vrdd_tpu_torch.kernels.slice_vjp import pallas_hist_render_diff

    blob = dict(centres=[0.45, 0.55, 0.5], widths=[0.05, 0.08, 0.06],
                jitter=0.05, sharpness=0.02, noise=0.5)
    hist = inputs.blob_histograms(12, 8, seed=5, device="cpu",
                                  dtype=torch.float32, blob=blob)
    rows = torch.as_tensor(inputs.unit_decode_rows(stat, 8))
    lut0 = torch.as_tensor(inputs.rainbow_lut())
    tscl = 6.0 if stat == "var" else 1.0
    h, lut = hist.clone().requires_grad_(), lut0.clone().requires_grad_()
    img = pallas_hist_render_diff(
        h, rows, (0.0, 0.0, 4.0), lut, density=0.5, transfer_scale=tscl,
        width=24, height=20, wrt=("hist", "lut"),
        stat={"mean": "linear"}.get(stat, stat))
    loss = torch.mean((img - 0.25) ** 2)
    d_hist, d_lut = torch.autograd.grad(loss, [h, lut])

    got = torch.zeros_like(hist)

    def keep(z0, z1, d):
        got[z0:z1] = d

    img_r, loss_r, d_lut_r, live = ref.fit_step(
        hist, rows, stat, lut0, 0.5, 0.0, tscl, width=24, height=20,
        origin=(0.0, 0.0, 4.0), focal=2.0, chunk=5, dtype=torch.float32,
        on_d_hist=keep)
    assert torch.allclose(img.detach(), img_r, atol=tol)
    assert abs(float(loss.detach()) - float(loss_r)) <= tol * float(loss_r)
    assert float((d_hist - got).norm() / got.norm()) < 10 * tol
    assert float((d_lut - d_lut_r).norm() / d_lut_r.norm()) < 10 * tol
    assert 0 < live < 12 * 24 * 20


def test_raw_stats_match_the_program():
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume

    field = inputs.smooth_field((20, 40, 40), seed=2, device="cpu",
                                blobs=[[0.5, 0.5, 0.5, 0.2, 1.0]], jitter=0.05)
    hist = inputs.block_histograms(field, (4, 4, 4), 32)
    assert torch.equal(RawHistogramVolume(hist).stats_volume(),
                       ref.raw_stats(hist, torch.float32))


@pytest.mark.parametrize("view", [(0.0, 0.0), (12.0, 40.0), (-28.0, 250.0)])
def test_frames_match_the_program(view, card_dispatch):
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig, TransferFunctionConfig)

    field = inputs.smooth_field((20, 40, 40), seed=4, device="cpu",
                                blobs=[[0.5, 0.5, 0.5, 0.2, 1.0],
                                       [0.3, 0.6, 0.4, 0.1, 0.6]], jitter=0.05)
    hist = inputs.block_histograms(field, (4, 4, 4), 32)
    pipe = RenderPipeline(raw=RawHistogramVolume(hist),
                          tf_lut=inputs.rainbow_lut())
    iv = inputs.inv_view(*view, 4.0)
    stats = ref.raw_stats(hist, torch.float32)
    for q, scale in ((1, 1.0), (2, 6.0), (3, 1.1)):
        cfg = RenderConfig(camera=CameraConfig(width=40, height=36),
                           tf=TransferFunctionConfig(offset=0.02, scale=scale),
                           query_method=QueryMethod(q))
        got = pipe.render(iv, cfg, "auto", as_uint8=True)
        frame = ref.orbit_frame if view != (0.0, 0.0) else ref.axis_frame
        kw = dict(oversample=2.0) if view != (0.0, 0.0) else {}
        want = frame(stats[..., q - 1].contiguous(), iv, inputs.rainbow_lut(),
                     0.05, 1.0, 0.02, scale, width=40, height=36, focal=2.0,
                     n_planes=64, dtype=torch.float32, **kw)
        gap = (got.to(torch.int16) - want.to(torch.int16)).abs()
        assert int(gap.max()) <= 1
        assert int(want[..., 3].max()) > 0


def test_inv_view_is_the_viewers():
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation

    for pitch, yaw in ((0.0, 0.0), (17.0, 233.0), (-30.0, 91.0)):
        assert np.allclose(inputs.inv_view(pitch, yaw, 4.0),
                           inv_view_from_rotation_translation(
                               pitch, yaw, (0.0, 0.0, -4.0)), atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_violations(ROOT / "benchmark/reference") == []


def test_forbidden_names_are_whole_top_level_names():
    mods = ["vrdd_tpu_torch", "vrdd_tpu_torch.kernels", "jaxtyping", "numpy"]
    assert imports.loaded_forbidden(mods) == []
    assert imports.loaded_forbidden(mods + ["vrdd_tpu.pallas"]) == ["vrdd_tpu"]
    assert imports.loaded_forbidden(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_no_forbidden_module():
    """The harness, the kinds and the program, imported in a fresh
    process as a run imports them, load neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.calibrate\n"
            "import benchmark.kinds.fit_hist, benchmark.kinds.pipeline_frames\n"
            "from benchmark import imports\n"
            "print(imports.loaded_forbidden())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
