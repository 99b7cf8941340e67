"""The CUDA kernels of vrdd_tpu_torch against their plain torch versions,
on the card. Marked ``cuda``: without a GPU every test skips.

Runs on a machine with an NVIDIA GPU and nvcc, without JAX (the repo's
tests/conftest.py imports JAX, so skip it there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: 1e-4 abs on all but 0.1% of pixels, which may flip at the 0.95
opacity cutoff (the kernel sums in another order than the plain matmuls).
Gradients (K5): relative L2 error 1e-3, for the atomics' summation order
and the same cutoff flips; two K5 runs agree bitwise on the LUT and
parameter cotangents (fixed-order block sums) and to 1e-6 relative L2 on
the plane cotangents (atomics).
"""

import numpy as np
import pytest
import torch

from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.kernels import slice_vjp as sv
from vrdd_tpu_torch.march.slice import slice_render_image

pytestmark = pytest.mark.cuda

TF = default_transfer_function()
O = torch.tensor([0.0, 0.0, 4.0])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    bad = ((got - ref).abs().amax(-1) > 1e-4).float().mean().item()
    assert bad <= 1e-3, bad


@pytest.mark.parametrize("n_planes", [0, 16])
@pytest.mark.parametrize("density", [0.05, 5.0])
def test_k1_matches_plain(dev, n_planes, density):
    vol = torch.from_numpy(gaussian_blob_volume((16, 24, 20))).to(dev)
    before = sk.sweep_preblended_planes.launches
    got = sk.pallas_slice_render(vol, O, TF, density, width=100, height=72,
                                 n_planes=n_planes)
    assert sk.sweep_preblended_planes.launches == before + 1
    again = sk.pallas_slice_render(vol, O, TF, density, width=100, height=72,
                                   n_planes=n_planes)
    assert torch.equal(got, again), "one thread per ray: bitwise reproducible"
    _close(got, slice_render_image(vol, O, 100, 72, TF, density,
                                   n_planes=n_planes))


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(dev, stat, dtype):
    rng = np.random.default_rng(1)
    h = rng.random((12, 8, 20, 24)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    hist = torch.from_numpy(h).to(dev, dtype)
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
    kw = dict(transfer_scale=10.0 if stat == "var" else 1.0, width=72,
              height=40, stat=mode)
    before = sk.pallas_hist_render.launches
    got = sk.pallas_hist_render(hist, rows, O, TF, 0.3, **kw)
    assert sk.pallas_hist_render.launches == before + 1
    _close(got, sk.hist_render_reference(hist, rows, O, TF, 0.3, **kw))


def test_kernel_rejects_what_it_does_not_take(dev):
    vol = torch.zeros((4, 4, 4), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        sk.pallas_slice_render(vol, O, TF, width=8, height=8, n_planes=4)
    vol = torch.zeros((4, 4, 8), device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sk.pallas_slice_render(vol, O, TF, width=8, height=8, n_planes=4)
    hist = torch.zeros((4, 4096, 4, 4), device=dev)
    with pytest.raises(ValueError, match="cannot render"):
        sk.pallas_hist_render(hist, np.ones((4, 4096), np.float32), O, TF,
                              width=8, height=8, stat="var")


def _rel_l2(got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _hist(dev, dtype, seed=1):
    """Smooth (12, 8, 20, 24) softmax histograms around a blob mean. On
    noise histograms the variance decode's cancellation (C2 - 2 m C1 +
    m^2 C0) moves a few samples across a LUT knot at rounding level, where
    the TF slope jumps: that tests rounding, not the algorithm."""
    base = gaussian_blob_volume((12, 20, 24), seed=seed)
    centers = ((np.arange(8) + 0.5) / 8).astype(np.float32)
    logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return torch.from_numpy(e / e.sum(axis=1, keepdims=True)).to(dev, dtype)


@pytest.mark.parametrize("n_planes", [16, 32])
@pytest.mark.parametrize("density", [0.05, 5.0])
def test_k3_k4_images_are_bitwise_the_forward(dev, n_planes, density):
    """K3 is K1 at brightness 1; K4's image is K3's, bit for bit."""
    vol = torch.from_numpy(gaussian_blob_volume((16, 24, 20))).to(dev)
    k1 = sk.pallas_slice_render(vol, O, TF, density, width=100, height=72,
                                n_planes=n_planes)
    before = (sv.sweep_fwd.launches, sv.sweep_fwd_ckpt.launches)
    with torch.no_grad():
        k3 = sv.pallas_slice_render_diff(vol, O, TF, density, width=100,
                                         height=72, n_planes=n_planes)
    k4 = sv.pallas_slice_render_diff(vol.clone().requires_grad_(), O, TF,
                                     density, width=100, height=72,
                                     n_planes=n_planes)
    torch.cuda.synchronize()
    assert (sv.sweep_fwd.launches, sv.sweep_fwd_ckpt.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(k3, k1)
    assert torch.equal(k4.detach(), k3)


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k4_hist_images_are_bitwise_k2(dev, stat, dtype):
    hist = _hist(dev, dtype)
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
    kw = dict(transfer_scale=10.0 if stat == "var" else 1.0, width=72,
              height=40, stat=mode)
    k2 = sk.pallas_hist_render(hist, rows, O, TF, 0.3, **kw)
    with torch.no_grad():
        k3 = sv.pallas_hist_render_diff(hist, rows, O, TF, 0.3, **kw)
    k4 = sv.pallas_hist_render_diff(hist.clone().requires_grad_(), rows, O,
                                    TF, 0.3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k3, k2)
    assert torch.equal(k4.detach(), k3)


def _grads(fn, leaves, seed=0):
    img = fn(*leaves)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(seed))
    return img, torch.autograd.grad(img, leaves, g.to(img.device))


@pytest.mark.parametrize("n_planes", [16, 32])
@pytest.mark.parametrize("density", [0.05, 5.0])
@pytest.mark.parametrize("plane_chunk", [4, 8])
def test_k5_scalar_matches_plain(dev, n_planes, density, plane_chunk):
    """Volume, LUT, density, TF offset and TF scale cotangents of K4/K5
    against the plain analytic VJP, at an unaligned shape."""
    vol = gaussian_blob_volume((16, 24, 24))
    params = np.array([density, 0.1, 1.5], np.float32)

    def fn(v, lut, d, to, ts):
        return sv.pallas_slice_render_diff(
            v, O, lut, d, 1.3, to, ts, width=100, height=72,
            n_planes=n_planes, plane_chunk=plane_chunk)

    out = []
    for device in (dev, "cpu"):
        leaves = [torch.tensor(x, device=device, requires_grad=True)
                  for x in (vol, TF, *params)]
        out.append(_grads(fn, leaves))
    before = sv.sweep_bwd.launches
    _grads(fn, [torch.tensor(x, device=dev, requires_grad=True)
                for x in (vol, TF, *params)])
    assert sv.sweep_bwd.launches == before + 1
    (img, grads), (img_ref, grads_ref) = out
    _close(img.detach(), img_ref.detach().to(dev))
    for name, g, r in zip(("volume", "lut", "density", "toff", "tscl"),
                          grads, grads_ref):
        assert _rel_l2(g, r) <= 1e-3, name


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("density", [0.05, 5.0])
@pytest.mark.parametrize("route", ["inkernel", "materialized"])
def test_k5_hist_matches_plain(dev, stat, dtype, density, route):
    """Histogram and LUT cotangents through K4/K5 (in-kernel decode, or
    the materialized decode and the scalar kernels) against the plain
    versions, at an unaligned shape (12 x 8 x 20 x 24 -> 136 x 96)."""
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")

    def fn(h, lut):
        return sv.pallas_hist_render_diff(
            h, rows, O, lut, density, width=136, height=96, stat=mode,
            transfer_scale=10.0 if stat == "var" else 1.0, route=route)

    out = []
    for device in (dev, "cpu"):
        leaves = [_hist(device, dtype).requires_grad_(),
                  torch.tensor(TF, device=device, requires_grad=True)]
        out.append(_grads(fn, leaves))
    (img, (gh, gl)), (img_ref, (gh_ref, gl_ref)) = out
    assert gh.dtype == dtype
    _close(img.detach(), img_ref.detach().to(dev))
    assert _rel_l2(gh, gh_ref) <= 1e-3
    assert _rel_l2(gl, gl_ref) <= 1e-3


@pytest.mark.parametrize("stat", ["mean", "var"])
def test_k5_two_runs(dev, stat):
    """LUT/param cotangents are bitwise reproducible; the atomics leave the
    histogram cotangent reproducible to 1e-6 relative L2."""
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
    runs = []
    for _ in range(2):
        leaves = [_hist(dev, torch.float32).requires_grad_(),
                  torch.tensor(TF, device=dev, requires_grad=True),
                  torch.tensor(0.3, device=dev, requires_grad=True)]
        runs.append(_grads(lambda h, lut, d: sv.pallas_hist_render_diff(
            h, rows, O, lut, d, width=136, height=96, stat=mode,
            transfer_scale=10.0 if stat == "var" else 1.0,
            wrt=("hist", "lut", "params")), leaves)[1])
    (gh1, gl1, gd1), (gh2, gl2, gd2) = runs
    assert torch.equal(gl1, gl2) and torch.equal(gd1, gd2)
    assert _rel_l2(gh1, gh2) <= 1e-6
