"""The multi-view Gaussian fit (``vrdd_tpu_torch/models/voxel_fit.py``, the
``fit-voxels`` job) against the plain reference
(``benchmark/reference/voxels.py``) at seeded random ``(mu, log sigma)``:
loss, renders and both gradients, with both renderers on the CPU ('pallas':
the kernels' plain versions on shear-warp's 128-rounded m-grid; 'slice':
the plain sweeps on the 'xla' m-grid) and the kernels on the card.

Five views at 60 degrees run every principal axis and both sweep
directions: (0, 0) along z, (+-60, 0) along y and (0, +-60) along x, one
of each pair with d_z -1 and the other +1.

Without JAX (the card's machine runs it with ``--noconftest``)."""

import numpy as np
import pytest
import torch

from benchmark.reference import voxels as ref
from vrdd_tpu_torch.march.shearwarp import slope_corner_bounds
from vrdd_tpu_torch.models import voxel_fit

VIEWS, ANGLE, SEED = 5, 60.0, 3

# The port and the reference compute the same float32 arithmetic in other
# orders: the plain sweeps resample by dense matmuls and sum the LUT's
# tent basis, the reference gathers; the 'xla' m-grid is a host linspace.
# Measured at these sizes: images within 4.7e-6, gradients 1.8e-6 (sums
# over ten renders), the loss equal; the limits keep about 10x room. The
# bfloat16 reference misses each by 100x or more (image 1.3e-2, gradients
# 5.8e-3 and 1.3e-2, loss 1.6e-3).
LIMITS = {"loss_rel": 1e-5, "image_max_abs": 5e-5, "d_mu_rel_l2": 2e-5,
          "d_log_sigma_rel_l2": 2e-5}
# On the card K4/K5 sum in another order again, K5 and the warp's backward
# scatter with atomics, and a ray whose alpha lands within rounding of the
# 0.95 cutoff may freeze one plane apart: the card tests' tolerances
# (tests/test_torch_cuda.py), a few pixels past 1e-4, gradients 1e-3.
CARD_LIMITS = {"loss_rel": 1e-4, "image_max_abs": 1e-2, "d_mu_rel_l2": 1e-3,
               "d_log_sigma_rel_l2": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(n, device):
    """Seeded random parameters away from the truth: ``mu`` in [0, 0.6],
    ``sigma`` in [0.05, 0.2]."""
    rng = np.random.default_rng(SEED)
    mu = (0.6 * rng.random((n, n, n))).astype(np.float32)
    sigma = (0.05 + 0.15 * rng.random((n, n, n))).astype(np.float32)
    return (torch.tensor(mu, device=device),
            torch.tensor(np.log(sigma), device=device))


def _port(n, image, renderer, device):
    """The port's loss, renders and gradients at :func:`_params`."""
    truth = voxel_fit.blob_truth(n, SEED, device)
    fit = voxel_fit.fit_problem(truth, views=VIEWS, view_angle=ANGLE,
                                image=image, renderer=renderer,
                                device=device)
    mu, ls = (t.requires_grad_() for t in _params(n, device))
    loss, renders = fit.loss(mu, ls)
    grads = torch.autograd.grad(loss, [mu, ls])
    return truth, loss.detach(), [tuple(r.detach() for r in p)
                                  for p in renders], grads


def _reference(n, image, round_to, dtype, device):
    """The reference's step at :func:`_params`, on its own truth."""
    mu, ls = _params(n, device)
    return ref.fit_step(mu, ls, ref.blob_truth(n, SEED, device), views=VIEWS,
                        view_angle=ANGLE, image=image, round_to=round_to,
                        chunk=8, dtype=dtype)


def _gaps(port, want):
    _, loss, renders, (d_mu, d_ls) = port
    loss_r, renders_r, d_mu_r, d_ls_r, live = want
    assert live > 0

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    return {
        "loss_rel": abs(float(loss) - float(loss_r)) / float(loss_r),
        "image_max_abs": max(float((a.float() - b.float()).abs().max())
                             for p, q in zip(renders, renders_r)
                             for a, b in zip(p, q)),
        "d_mu_rel_l2": rel(d_mu, d_mu_r),
        "d_log_sigma_rel_l2": rel(d_ls, d_ls_r),
    }


def _within(gaps, limits):
    return {k: v for k, v in gaps.items() if not v <= limits[k]}


def test_views_cover_every_axis_and_direction():
    """The five 60-degree views sweep along z, y and x, and along y and x
    in both directions."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation

    got = set()
    for rx, ry in voxel_fit.view_list(VIEWS, ANGLE):
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        axis, _, dz_sign, ok, _ = slope_corner_bounds(iv, 36, 36)
        assert ok
        got.add((axis, dz_sign))
    assert got == {(2, -1), (1, -1), (1, 1), (0, -1), (0, 1)}


@pytest.fixture(scope="module")
def pallas_run():
    port = _port(24, 36, "pallas", torch.device("cpu"))
    return port, _reference(24, 36, 128, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("renderer,round_to", [("pallas", 128), ("slice", 1)])
def test_port_matches_the_reference(pallas_run, renderer, round_to):
    """Loss, all ten renders and both gradients within :data:`LIMITS` of
    the float32 reference on the renderer's m-grid."""
    if renderer == "pallas":
        port, want = pallas_run
    else:
        port = _port(24, 36, renderer, torch.device("cpu"))
        want = _reference(24, 36, round_to, torch.float32,
                          torch.device("cpu"))
    gaps = _gaps(port, want)
    assert not _within(gaps, LIMITS), gaps


def test_bf16_reference_fails_the_limits(pallas_run):
    """The limits can tell a precision lower: the reference in bfloat16
    misses at least one of them against the float32 reference."""
    port, want = pallas_run
    loss, renders, d_mu, d_ls, _ = _reference(24, 36, 128, torch.bfloat16,
                                              torch.device("cpu"))
    control = (port[0], loss, renders, (d_mu, d_ls))
    assert _within(_gaps(control, want), LIMITS)


@pytest.mark.parametrize("n,seed", [(12, 3), (17, 2 ** 32 + 15)])
def test_reference_truth_is_the_programs(n, seed):
    """The reference makes the job's ground truth from the seed itself: the
    program's blobs to float32 rounding."""
    dev = torch.device("cpu")
    for got, want in zip(voxel_fit.blob_truth(n, seed, dev),
                         ref.blob_truth(n, seed, dev)):
        assert got.dtype == want.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_reference_adam_is_torchs():
    """The reference's plain Adam step, from a snapshot of the moments and
    the step count, moves the parameters as ``torch.optim.Adam`` does (to
    float32 rounding, 1e-6 of the step), from a fresh state and from one
    with history."""
    gen = torch.Generator().manual_seed(SEED)
    params = [torch.randn(40, generator=gen).requires_grad_(),
              torch.randn(3, 5, generator=gen).requires_grad_()]
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        snap = [p.detach().clone() for p in params]
        state = [(opt.state[p]["exp_avg"].clone(),
                  opt.state[p]["exp_avg_sq"].clone(), int(opt.state[p]["step"]))
                 if p in opt.state else
                 (torch.zeros_like(p), torch.zeros_like(p), 0)
                 for p in params]
        grads = [1e-8 * torch.randn(p.shape, generator=gen) for p in params]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        want = ref.adam_update(snap, grads, state, lr=1e-3,
                               betas=(0.9, 0.999), eps=1e-8)
        for p, w, p0 in zip(params, want, snap):
            step = float((w - p0).abs().max())
            assert step > 0
            assert float((p.detach() - w).abs().max()) <= 1e-6 * step


def test_cli_problem_is_the_module():
    """``cli.fit_voxels_problem`` builds the job through the module: the
    same loss at the same parameters."""
    from vrdd_tpu_torch import cli

    dev = torch.device("cpu")
    loss_fn, mu_true, renderer = cli.fit_voxels_problem(
        12, 20, 3, ANGLE, SEED, "pallas", False, dev)
    truth = voxel_fit.blob_truth(12, SEED, dev)
    fit = voxel_fit.fit_problem(truth, views=3, view_angle=ANGLE, image=20,
                                renderer="pallas", device=dev)
    assert renderer == fit.renderer == "pallas"
    assert torch.equal(mu_true, truth[0])
    mu, ls = _params(12, dev)
    assert float(loss_fn(mu, ls)) == float(fit.loss(mu, ls)[0])


def test_train_step_counts_and_updates():
    """One step renders two channels a view (two of them rotated a rotated
    view), updates both volumes and leaves the gradients on them."""
    from vrdd_tpu_torch.utils import profiling

    dev = torch.device("cpu")
    fit = voxel_fit.fit_problem(voxel_fit.blob_truth(10, SEED, dev),
                                views=3, view_angle=ANGLE, image=16,
                                renderer="pallas", device=dev)
    mu, ls = (t.requires_grad_() for t in _params(10, dev))
    before = (mu.detach().clone(), ls.detach().clone())
    opt = torch.optim.Adam([mu, ls], lr=1e-3)
    profiling.enable()
    try:
        loss, renders = voxel_fit.train_step(fit, opt, mu, ls)
    finally:
        profiling.disable()
        spans, counters = profiling.drain()
    assert counters["voxel_fit.renders"] == 6
    assert counters["voxel_fit.renders_rotated"] == 4
    # two rotated views' permuted copies of both 10^3 float32 channels
    assert counters["shearwarp.copy_bytes"] == 4 * 10 ** 3 * 4
    names = [s.name for s in spans]
    assert names.count("voxel_fit.view") == 3
    for name in ("voxel_fit.decode", "voxel_fit.loss", "voxel_fit.backward",
                 "voxel_fit.adam"):
        assert names.count(name) == 1
    assert len(renders) == 3 and float(loss.detach()) > 0
    assert mu.grad is not None and ls.grad is not None
    assert not torch.equal(mu.detach(), before[0])
    assert not torch.equal(ls.detach(), before[1])


@pytest.mark.cuda
def test_card_matches_the_reference():
    """The kernels (K4/K5 unrotated and under shear-warp on every axis,
    both directions) at an unaligned size, 40^3 to 72^2, against the
    float32 reference on the card, within :data:`CARD_LIMITS`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    port = _port(40, 72, "pallas", dev)
    want = _reference(40, 72, 128, torch.float32, dev)
    gaps = _gaps(port, want)
    assert not _within(gaps, CARD_LIMITS), gaps
