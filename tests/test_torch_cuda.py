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
@pytest.mark.parametrize("staged", [True, False])
def test_k3_k4_hist_images_are_bitwise_k2(dev, stat, dtype, staged):
    hist = _hist(dev, dtype)
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
    kw = dict(transfer_scale=10.0 if stat == "var" else 1.0, width=72,
              height=40, stat=mode)
    before = sk.pallas_hist_render.staged_launches
    with sk._fetch_path(staged):
        k2 = sk.pallas_hist_render(hist, rows, O, TF, 0.3, **kw)
        with torch.no_grad():
            k3 = sv.pallas_hist_render_diff(hist, rows, O, TF, 0.3, **kw)
        k4 = sv.pallas_hist_render_diff(hist.clone().requires_grad_(), rows,
                                        O, TF, 0.3, **kw)
    torch.cuda.synchronize()
    assert sk.pallas_hist_render.staged_launches == before + staged
    assert torch.equal(k3, k2)
    assert torch.equal(k4.detach(), k3)


_DIFF = (sv.sweep_fwd, sv.sweep_fwd_ckpt, sv.sweep_bwd)


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
@pytest.mark.parametrize("staged", [True, False])
def test_k5_hist_matches_plain(dev, stat, dtype, density, route, staged):
    """Histogram and LUT cotangents through K4/K5 (in-kernel decode, or
    the materialized decode and the scalar kernels) against the plain
    versions, at an unaligned shape (12 x 8 x 20 x 24 -> 136 x 96), on the
    staged and on the direct fetch path."""
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")

    def fn(h, lut):
        return sv.pallas_hist_render_diff(
            h, rows, O, lut, density, width=136, height=96, stat=mode,
            transfer_scale=10.0 if stat == "var" else 1.0, route=route)

    out = []
    before = [c.staged_launches for c in _DIFF]
    for device in (dev, "cpu"):
        leaves = [_hist(device, dtype).requires_grad_(),
                  torch.tensor(TF, device=device, requires_grad=True)]
        with sk._fetch_path(staged):
            out.append(_grads(fn, leaves))
    torch.cuda.synchronize()
    assert [c.staged_launches - b for c, b in zip(_DIFF, before)] == [
        0, int(staged), int(staged)]
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


# ---- empty-space skipping (K1/K3/K4) ----------------------------------------

def _band_lut():
    """Zero alpha below ~0.5, a ramp above (tests/test_pallas_slice.py:91-95)."""
    lut = np.zeros((8, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 8)
    lut[5:, 3] = [0.3, 0.7, 1.0]
    return lut


ESS_LUTS = {"rainbow": (TF, 0.0, 1.0), "band": (_band_lut(), 0.0, 1.0),
            "negative_scale": (TF, 1.0, -1.0)}


def _sparse_blob(dev, n=24):
    """A 24^3 blob volume with its low values cut to 0: empty space."""
    v = torch.from_numpy(gaussian_blob_volume((n, n, n), seed=3))
    return torch.where(v > 0.35, v, 0.0).to(dev)


@pytest.mark.parametrize("lut_name", sorted(ESS_LUTS))
@pytest.mark.parametrize("size", [(100, 72), (136, 96)])
@pytest.mark.parametrize("n_planes", [24, 48])
def test_k1_ess_is_bitwise_k1(dev, lut_name, size, n_planes):
    """K1 with ESS is bitwise K1 without it (culled samples have alpha
    exactly 0), at images unaligned to the 32 x 8 tile; and it matches the
    plain version given the same bitmap. n_planes == nz is the
    pure-selection schedule (cached stats), 2 nz the pre-blend."""
    lut, toff, tscl = ESS_LUTS[lut_name]
    vol = _sparse_blob(dev)
    W, H = size
    kw = dict(width=W, height=H, n_planes=n_planes, transfer_offset=toff,
              transfer_scale=tscl)
    plain_k1 = sk.pallas_slice_render(vol, O, lut, 0.8, **kw)
    before = sk.sweep_preblended_planes.launches
    got = sk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                 **kw)
    stats = sk.precompute_ess_stats(vol, n_planes=n_planes)
    cached = sk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                    ess_stats=stats, **kw)
    torch.cuda.synchronize()
    assert sk.sweep_preblended_planes.launches == before + 2
    assert torch.equal(got, plain_k1) and torch.equal(cached, plain_k1)
    assert float(got[..., 3].max()) > 0.05, "vacuous: empty render"
    # the plain version with the same bitmap
    planes, zs = sk.preblend_planes(vol, n_planes, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    slopes = sk.pixel_slope_params(W, H)
    bitmap = sk.ess_bitmap(sk.ess_plane_stats(planes), zs, O, slopes, lut,
                           toff, tscl, width=W, height=H, ny=24, nx=24,
                           plane_chunk=8)
    assert bool((bitmap == 0).any()), "vacuous: nothing culled"
    ref = sk.sweep_preblended_planes_reference(
        planes, zs, O, slopes, lut, 0.8, 1.0, toff, tscl, width=W, height=H,
        ess=bitmap)
    _close(got, ref)


def _long_band_lut():
    """40 entries: zero alpha on [0, 0.5), then a ramp with a zero gap."""
    lut = np.zeros((40, 4), dtype=np.float32)
    lut[:, 1] = np.linspace(0, 1, 40)
    lut[20:, 3] = np.linspace(0.2, 1.0, 20)
    lut[30:33, 3] = 0.0
    return lut


BITMAP_CASES = {
    # name: (lut, transfer_offset, transfer_scale, width, height,
    #        tex_offset, axis_scale, n_planes, chunk)
    "rainbow": (TF, 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 48, 8),
    "band": (_band_lut(), 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 48, 8),
    "negative_scale": (TF, 1.0, -1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 48, 8),
    "axis_scale": (_band_lut(), 0.0, 1.0, 64, 48, 0.5,
                   (12 / 13, 12 / 13, 10 / 11), 48, 8),
    "tex_offset_0": (TF, 0.0, 1.0, 64, 48, 0.0, (1.0, 1.0, 1.0), 48, 8),
    "unaligned": (_band_lut(), 0.0, 1.0, 100, 37, 0.5, (1.0, 1.0, 1.0), 45,
                  4),
    "long_lut": (_long_band_lut(), 0.0, 1.0, 136, 96, 0.5, (1.0, 1.0, 1.0),
                 48, 8),
}


@pytest.mark.parametrize("case", sorted(BITMAP_CASES))
def test_ess_bitmap_kernel_equals_plain(dev, case):
    """The bitmap kernel's bytes are the plain version's, for the LUT /
    scale / offset / grid cases whose conservativeness the CPU brute-force
    test (tests/test_torch_ess.py) checks on the plain version."""
    lut, toff, tscl, W, H, tex_offset, axis_scale, n_planes, chunk = (
        BITMAP_CASES[case])
    march = sk.MarchConfig()
    planes, zs = sk.preblend_planes(_sparse_blob(dev), n_planes,
                                    march.box_min, march.box_max, -1,
                                    tex_offset, z_scale=axis_scale[2])
    stats = sk.ess_plane_stats(planes)
    kw = dict(width=W, height=H, ny=24, nx=24, plane_chunk=chunk,
              march=march, tex_offset=tex_offset, axis_scale=axis_scale[:2])
    args = (zs, O, sk.pixel_slope_params(W, H), lut, toff, tscl)
    before = sk.ess_bitmap.launches
    got = sk.ess_bitmap(stats, *args, **kw)
    torch.cuda.synchronize()
    assert sk.ess_bitmap.launches == before + 1
    ref = sk.ess_bitmap_reference(tuple(t.cpu() for t in stats), *args, **kw)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), ref), int((got.cpu() != ref).sum())
    assert bool((ref == 0).any()) and bool((ref != 0).any()), "vacuous"


@pytest.mark.parametrize("lut_name", sorted(ESS_LUTS))
@pytest.mark.parametrize("ck_stride", [4, 8])
def test_k3_k4_ess_are_bitwise(dev, lut_name, ck_stride):
    """K3's image and K4's image and every checkpoint row with the ESS
    bitmap are bitwise those without it."""
    import dataclasses

    lut, toff, tscl = ESS_LUTS[lut_name]
    vol = _sparse_blob(dev)
    planes, zs = sk.preblend_planes(vol, 48, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    slopes = sk.pixel_slope_params(100, 72)
    cfg = sv.planes_config(zs, O, slopes, width=100, height=72, n_planes=48,
                           plane_chunk=ck_stride)
    bitmap = sk.ess_bitmap(sk.ess_plane_stats(planes), zs, O, slopes, lut,
                           toff, tscl, width=100, height=72, ny=24, nx=24,
                           plane_chunk=ck_stride)
    ess_cfg = dataclasses.replace(cfg, ess=bitmap)
    args = (planes, None, torch.tensor(lut, device=dev),
            torch.tensor(0.8, device=dev), torch.tensor(toff, device=dev),
            torch.tensor(tscl, device=dev))
    assert torch.equal(sv.sweep_fwd(ess_cfg, *args), sv.sweep_fwd(cfg, *args))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    img_e, tck_e = sv.sweep_fwd_ckpt(ess_cfg, *args)
    torch.cuda.synchronize()
    assert torch.equal(img_e, img) and torch.equal(tck_e, tck)
    assert bool((bitmap == 0).any()), "vacuous: nothing culled"


def test_diff_ess_volume_gradient(dev):
    """pallas_slice_render_diff(wrt=('volume',), empty_space_skip=True):
    the image is bitwise the one without ESS, d_volume within 1e-6 relative
    L2 (K5's atomics)."""
    vol = _sparse_blob(dev)
    out = []
    for ess in (False, True):
        v = vol.clone().requires_grad_()
        img = sv.pallas_slice_render_diff(v, O, _band_lut(), 0.8, width=100,
                                          height=72, wrt=("volume",),
                                          empty_space_skip=ess)
        (g,) = torch.autograd.grad((img * img).sum(), [v])
        out.append((img.detach(), g))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0])
    assert float(out[0][1].abs().max()) > 0.0
    assert _rel_l2(out[1][1], out[0][1]) <= 1e-6


def test_pipeline_auto_is_pallas_with_ess_on_the_card(dev):
    """RenderPipeline on the card: 'auto' resolves to the fused kernel,
    which renders with ESS on; it matches the plain 'slice' renderer."""
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig)

    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    p = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(hist).to(dev)))
    for q in (1, 2, 3, 7):
        cfg = RenderConfig(camera=CameraConfig(width=96, height=80),
                           density=0.5, query_method=QueryMethod(q))
        assert p.resolve_renderer("auto", np.eye(3, 4, dtype=np.float32)
                                  + np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                                              [0, 0, 0, 4]], np.float32),
                                  cfg) == "pallas"
        before = sk.sweep_preblended_planes.launches
        got = p.render(None, cfg, "auto")
        assert sk.sweep_preblended_planes.launches == before + 1
        _close(got, p.render(None, cfg, "slice"))
    assert p._ess_cache, "ESS stats were not computed"


# ---- the seeded sweep (K1/K3/K4/K5) and shear-warp --------------------------

def _stack(dev, n=24, n_planes=48):
    """A 24^3 blob's 48-plane stack, its depths and 100 x 72 slopes."""
    vol = torch.from_numpy(gaussian_blob_volume((n, n, n), seed=5)).to(dev)
    planes, zs = sk.preblend_planes(vol, n_planes, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    return planes, zs, sk.pixel_slope_params(100, 72)


def _frozen_seed(img):
    """``img`` with a few pixels replaced by frozen seeds: alpha 0.99 and
    exactly 1 (past the 0.95 cutoff), and 0.5 (live)."""
    seed = img.clone()
    seed[10, 10:13] = torch.tensor([[0.2, 0.1, 0.3, 0.99],
                                    [0.4, 0.0, 0.1, 1.0],
                                    [0.1, 0.1, 0.1, 0.5]], device=img.device)
    return seed


@pytest.mark.parametrize("density", [0.8, 5.0])
def test_seeded_k1_resumes_the_sweep(dev, density):
    """K1 over the back half seeded with the front half's image equals the
    one-pass sweep; a frozen seed comes back as itself x brightness; the
    kernel matches its plain version from the same seed."""
    planes, zs, slopes = _stack(dev)
    sp = 2.0 / planes.shape[0]
    kw = dict(width=100, height=72, plane_spacing=sp)
    full = sk.sweep_preblended_planes(planes, zs, O, slopes, TF, density,
                                      **kw)
    front = sk.sweep_preblended_planes(planes[:24], zs[:24], O, slopes, TF,
                                       density, **kw)
    before = sk.sweep_preblended_planes.launches
    back = sk.sweep_preblended_planes(planes[24:], zs[24:], O, slopes, TF,
                                      density, acc_init=front, **kw)
    assert sk.sweep_preblended_planes.launches == before + 1
    _close(back, full)
    seed = _frozen_seed(front)
    got = sk.sweep_preblended_planes(planes[24:], zs[24:], O, slopes, TF,
                                     density, 1.3, acc_init=seed, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[10, 10:12], seed[10, 10:12] * 1.3)
    ref = sk.sweep_preblended_planes_reference(
        planes[24:].cpu(), zs[24:], O, slopes, TF, density, 1.3,
        acc_init=seed.cpu(), **kw)
    _close(got, ref.to(dev))


def test_null_seed_is_the_unseeded_sweep(dev):
    """A null seed pointer is the unseeded kernel; a zero seed gives the same
    bits (acc 0, T 1), for K1 and for K4's image and checkpoints."""
    planes, zs, slopes = _stack(dev)
    kw = dict(width=100, height=72)
    zero = torch.zeros((72, 100, 4), device=dev)
    assert torch.equal(
        sk.sweep_preblended_planes(planes, zs, O, slopes, TF, 0.8, **kw),
        sk.sweep_preblended_planes(planes, zs, O, slopes, TF, 0.8,
                                   acc_init=zero, **kw))
    cfg = sv.planes_config(zs, O, slopes, n_planes=48, **kw)
    args = (planes, None, torch.tensor(TF, device=dev),
            torch.tensor(0.8, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    img0, tck0 = sv.sweep_fwd_ckpt(cfg, *args, zero)
    assert torch.equal(img, img0) and torch.equal(tck, tck0)


def test_seed_and_ess_are_refused(dev):
    planes, zs, slopes = _stack(dev)
    seed = torch.zeros((72, 100, 4), device=dev)
    with pytest.raises(ValueError, match="empty-space"):
        sk.sweep_preblended_planes(planes, zs, O, slopes, TF, width=100,
                                   height=72, acc_init=seed,
                                   empty_space_skip=True)
    # the kernel itself refuses the pair (cudaErrorInvalidValue)
    bitmap = sk.ess_bitmap(sk.ess_plane_stats(planes), zs, O, slopes, TF,
                           0.0, 1.0, width=100, height=72, ny=24, nx=24,
                           plane_chunk=8)
    params = sk._sweep_params(
        O, slopes, 0.8, 1.0, 0.0, 1.0, 2.0 / 48, sk.MarchConfig(),
        width=100, height=72, ny=24, nx=24, n_planes=48, n_layers=48,
        dz_sign=-1, reverse=False, length_correction=True, tex_offset=0.5,
        axis_scale=(1.0, 1.0), filter_linear=True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._launch(planes, "none", zs, TF, None, params, ess=bitmap,
                   ess_chunk=8, seed=seed)


@pytest.mark.parametrize("density", [0.8, 5.0])
@pytest.mark.parametrize("ck_stride", [4, 8])
@pytest.mark.parametrize("staged", [True, False])
def test_seeded_k3_k4_k5_match_plain(dev, density, ck_stride, staged):
    """Seeded K3/K4/K5 against their plain versions at 24^3 -> 100 x 72,
    with frozen seeds, on either fetch path: K4's image is K3's, the
    checkpoint rows of a frozen pixel are all T0 = 1 - seed_a, its S is 0
    and its d seed_a is g_a; S, d_planes and the LUT cotangent within 1e-3
    relative L2; d_acc0 through the public wrapper against the plain
    analytic VJP."""
    with sk._fetch_path(staged):
        _seeded_k3_k4_k5(dev, density, ck_stride)


def _seeded_k3_k4_k5(dev, density, ck_stride):
    planes, zs, slopes = _stack(dev)
    sp = 2.0 / planes.shape[0]
    front = sk.sweep_preblended_planes(planes[:24], zs[:24], O, slopes, TF,
                                       density, width=100, height=72,
                                       plane_spacing=sp)
    seed = _frozen_seed(front)
    cfg = sv.planes_config(zs[24:], O, slopes, width=100, height=72,
                           n_planes=24, plane_spacing=sp,
                           plane_chunk=ck_stride)
    back = planes[24:].contiguous()
    args = (back, None, torch.tensor(TF, device=dev),
            torch.tensor(density, device=dev), torch.tensor(0.1, device=dev),
            torch.tensor(1.5, device=dev))
    cpu_args = tuple(None if a is None else a.cpu() for a in args)
    k3 = sv.sweep_fwd(cfg, *args, seed)
    img, tck = sv.sweep_fwd_ckpt(cfg, *args, seed)
    torch.cuda.synchronize()
    assert torch.equal(img, k3)
    assert torch.equal(img[10, 10:12], seed[10, 10:12])
    t0 = 1.0 - seed[10, 10:12, 3]
    assert torch.equal(tck[:, 10, 10:12], t0.expand(tck.shape[0], 2))
    ref_img, ref_tck = sv.sweep_fwd_ckpt_reference(cfg, *cpu_args, seed.cpu())
    _close(img, ref_img.to(dev))
    _close(tck[..., None], ref_tck[..., None].to(dev))
    g = torch.randn((72, 100, 4), generator=torch.Generator().manual_seed(1))
    before = sv.sweep_bwd.launches
    d, small, _, s_img = sv.sweep_bwd(cfg, *args, g.to(dev), tck, True, True,
                                      False, acc0=seed)
    torch.cuda.synchronize()
    assert sv.sweep_bwd.launches == before + 1
    assert torch.equal(s_img[10, 10:12], torch.zeros(2, device=dev))
    d_r, small_r, _, s_r = sv.sweep_bwd_reference(cfg, *cpu_args, g, True,
                                                  True, False, seed.cpu())
    for got, ref in ((d, d_r), (small, small_r), (s_img, s_r)):
        assert _rel_l2(got, ref) <= 1e-3
    # d_acc0 through the autograd Function, against the plain analytic VJP
    out = []
    for device in (dev, "cpu"):
        leaves = [back.to(device).clone().requires_grad_(),
                  seed.to(device).clone().requires_grad_()]
        out.append(_grads(lambda p, a: sv.sweep_preblended_planes_diff(
            p, zs[24:], O, slopes, TF, density, 1.3, width=100, height=72,
            plane_spacing=sp, plane_chunk=ck_stride, acc_init=a), leaves))
    (img_k, (gp, ga)), (img_p, (gp_r, ga_r)) = out
    _close(img_k.detach(), img_p.detach().to(dev))
    assert _rel_l2(gp, gp_r) <= 1e-3 and _rel_l2(ga, ga_r) <= 1e-3
    g1 = torch.randn((72, 100, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(ga[10, 10:12].cpu(), 1.3 * g1[10, 10:12])
    # the seed's cotangent alone: K5 runs for S with no other cotangent
    a0 = seed.clone().requires_grad_()
    before = sv.sweep_bwd.seed_launches
    (ga0,) = _grads(lambda a: sv.sweep_preblended_planes_diff(
        back, zs[24:], O, slopes, TF, density, 1.3, width=100, height=72,
        plane_spacing=sp, plane_chunk=ck_stride, acc_init=a), [a0])[1]
    assert sv.sweep_bwd.seed_launches == before + 1
    assert _rel_l2(ga0, ga_r) <= 1e-3


def test_seeded_hist_sweep_matches_plain(dev):
    """The in-kernel decode sweep seeded (linear): image, d_hist and d_acc0
    against the plain versions."""
    hist = _hist(dev, torch.float32)
    rows, _ = sk.decode_weight_rows("mean", 8, family="unit")
    cfg = sv.render_config(hist.shape, O, stat="linear", width=72, height=40)
    seed = _frozen_seed(sv.sweep_fwd(
        cfg, hist[6:], torch.as_tensor(rows, device=dev),
        torch.tensor(TF, device=dev), torch.tensor(0.3, device=dev),
        torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)))
    out = []
    for device in (dev, "cpu"):
        leaves = [hist[:6].to(device).clone().requires_grad_(),
                  seed.to(device).clone().requires_grad_()]
        out.append(_grads(lambda h, a: sv.sweep_preblended_hist_diff(
            h, rows, cfg.zs[6:], O, cfg.slopes, TF, 0.3, width=72, height=40,
            plane_spacing=cfg.plane_spacing, acc_init=a), leaves))
    (img, (gh, ga)), (img_r, (gh_r, ga_r)) = out
    _close(img.detach(), img_r.detach().to(dev))
    assert _rel_l2(gh, gh_r) <= 1e-3 and _rel_l2(ga, ga_r) <= 1e-3


SW_VIEWS = [(25.0, 0.0), (0.0, 60.0), (60.0, 0.0), (0.0, 180.0),
            (180.0, 30.0)]


@pytest.mark.parametrize("view", SW_VIEWS)
def test_shearwarp_pallas_matches_plain(dev, view):
    """Shear-warp on the fused sweep (K3 forward; K4/K5 under autograd)
    against the same path's plain versions on the CPU, for all three
    principal axes and both d_z signs: image at the image tolerance,
    d_volume within 1e-3 relative L2 (atomics in K5 and the warp's
    scatter)."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.march import shearwarp as sw

    iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
    vol = gaussian_blob_volume((20, 24, 28), seed=2)
    before = sv.sweep_fwd.launches
    with torch.no_grad():
        got = sw.shearwarp_render_image(torch.from_numpy(vol).to(dev), iv,
                                        100, 72, TF, 0.5, backend="pallas")
    assert sv.sweep_fwd.launches == before + 1
    ref = sw.shearwarp_render_image(torch.from_numpy(vol), iv, 100, 72, TF,
                                    0.5, backend="pallas")
    _close(got, ref.to(dev))
    assert float(ref[..., 3].max()) > 0.05, "vacuous: empty render"
    out = []
    for device in (dev, "cpu"):
        v = torch.tensor(vol, device=device, requires_grad=True)
        img = sw.shearwarp_render_image(v, iv, 100, 72, TF, 0.5,
                                        backend="pallas", wrt=("volume",))
        out.append(torch.autograd.grad((img * img).sum(), [v])[0])
    assert _rel_l2(out[0], out[1]) <= 1e-3


def test_streaming_pallas_matches_plain(dev):
    """The streamed decode on the card (chained seeded K4/K5, recomputed
    under torch.utils.checkpoint) against the same path on the CPU."""
    from vrdd_tpu_torch.march.streaming import streaming_decode_render
    from vrdd_tpu_torch.ops.gaussian import gaussian_stats

    rng = np.random.default_rng(4)
    mu = rng.random((16, 20, 24), dtype=np.float32)
    ls = np.log(0.05 + 0.2 * rng.random((16, 20, 24), dtype=np.float32))
    out = []
    for device in (dev, "cpu"):
        leaves = [torch.tensor(x, device=device, requires_grad=True)
                  for x in (mu, ls)]
        before = sv.sweep_fwd_ckpt.launches
        out.append(_grads(lambda m, s: streaming_decode_render(
            (m, s), lambda t: gaussian_stats(t[0], torch.exp(t[1]))[..., 1],
            O, TF, 0.5, transfer_scale=20.0, width=100, height=72,
            n_planes=32, chunk_planes=8, backend="pallas", wrt=("volume",)),
            leaves))
        if device != "cpu":
            torch.cuda.synchronize()
            # four chunks, each K4 in the forward and again in the recompute
            assert sv.sweep_fwd_ckpt.launches == before + 8
    (img, (gm, gs)), (img_r, (gm_r, gs_r)) = out
    _close(img.detach(), img_r.detach().to(dev))
    assert _rel_l2(gs, gs_r) <= 1e-3


def test_auto_sends_card_data_to_the_kernels(dev):
    """'auto' picks the kernels for data on the card: shear-warp and the
    streamed decode launch K3 there, and a configuration the kernels cannot
    take (a LUT past their shared memory) raises instead of falling back to
    the plain sweep, also through RenderPipeline's rotated 'auto'."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.march import shearwarp as sw
    from vrdd_tpu_torch.march.streaming import streaming_decode_render
    from vrdd_tpu_torch.models.pipeline import RenderPipeline
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume
    from vrdd_tpu_torch.utils.config import CameraConfig, RenderConfig

    vol = torch.from_numpy(gaussian_blob_volume((16, 20, 24), seed=1)).to(dev)
    iv = inv_view_from_rotation_translation(20.0, 0.0, (0.0, 0.0, -4.0))
    big = np.tile(TF, (4096 // len(TF) + 1, 1))[:4096]

    def stream(lut):
        return streaming_decode_render(vol, lambda t: t, O, lut, 0.5,
                                       width=48, height=40, n_planes=32,
                                       chunk_planes=8)

    before = sv.sweep_fwd.launches
    sw.shearwarp_render_image(vol, iv, 48, 40, TF, 0.5)
    stream(TF)
    torch.cuda.synchronize()
    assert sv.sweep_fwd.launches == before + 1 + 4
    with pytest.raises(ValueError, match="cannot"):
        sw.shearwarp_render_image(vol, iv, 48, 40, big, 0.5)
    with pytest.raises(ValueError, match="cannot"):
        stream(big)
    hist = np.random.default_rng(0).random((6, 8, 10, 32), dtype=np.float32)
    p = RenderPipeline(raw=RawHistogramVolume(torch.from_numpy(hist).to(dev)),
                       tf_lut=big)
    cfg = RenderConfig(camera=CameraConfig(width=48, height=40))
    assert p.resolve_renderer("auto", iv, cfg) == "shearwarp"
    with pytest.raises(ValueError, match="cannot"):
        p.render(iv, cfg, "auto")


# ---- the staged and the direct fetch paths ----------------------------------

def _case(dev, kind, dtype, size):
    """``(cfg, vol, rows)`` of a small sweep: a 24^3 blob's 48-plane stack
    ('none'), or the in-kernel decode of 24^2 / 20 x 24 smooth histograms."""
    W, H = size
    if kind == "none":
        planes, zs, _ = _stack(dev)
        cfg = sv.planes_config(zs, O, sk.pixel_slope_params(W, H), width=W,
                               height=H, n_planes=48)
        return cfg, planes.to(dtype).contiguous(), None
    stat = {"linear": "mean", "var": "var", "entropy": "entropy"}[kind]
    rows, _ = sk.decode_weight_rows(stat, 8, family="unit")
    hist = torch.from_numpy(_smooth_hist((16, 8, 24, 24), seed=2)).to(
        dev, dtype)
    cfg = sv.render_config(hist.shape, O, stat=kind, width=W, height=H)
    return cfg, hist, torch.as_tensor(rows, device=dev)


def _smooth_hist(shape, seed):
    nz, B, ny, nx = shape
    base = gaussian_blob_volume((nz, ny, nx), seed=seed)
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _scalars(dev, kind):
    return (torch.tensor(TF, device=dev), torch.tensor(0.8, device=dev),
            torch.tensor(0.0, device=dev),
            torch.tensor(10.0 if kind == "var" else 1.0, device=dev))


SIZES = [(100, 72), (136, 96), (20, 6)]  # the last: less than one block


@pytest.mark.parametrize("kind", ["none", "linear", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ck_stride", [4, 8])
def test_staged_k3_k4_are_bitwise_direct(dev, kind, dtype, size, ck_stride):
    """K3's image and K4's image and every checkpoint row on the staged path
    are bitwise the direct path's, at odd sizes (24 x 24 volumes, images
    unaligned to the 32 x 8 block and smaller than one)."""
    import dataclasses

    cfg, vol, rows = _case(dev, kind, dtype, size)
    cfg = dataclasses.replace(cfg, ck_stride=ck_stride)
    args = (vol, rows, *_scalars(dev, kind))
    before = (sv.sweep_fwd.staged_launches, sv.sweep_fwd_ckpt.staged_launches)
    k3 = {s: sv.sweep_fwd(cfg, *args, staged=s) for s in (True, False)}
    k4 = {s: sv.sweep_fwd_ckpt(cfg, *args, staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert (sv.sweep_fwd.staged_launches, sv.sweep_fwd_ckpt.staged_launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(k3[True], k3[False])
    assert torch.equal(k4[True][0], k4[False][0])
    assert torch.equal(k4[True][1], k4[False][1])
    assert torch.equal(k4[True][0], k3[True])
    assert float(k3[True][..., 3].max()) > 0.05, "vacuous: empty render"


@pytest.mark.parametrize("ck_stride", [4, 8])
def test_staged_ess_and_seed_are_bitwise_direct(dev, ck_stride):
    """With an ESS bitmap, and from a seed with frozen pixels, the staged
    K3/K4 images and checkpoints are bitwise the direct ones."""
    import dataclasses

    vol = _sparse_blob(dev)
    planes, zs = sk.preblend_planes(vol, 48, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    slopes = sk.pixel_slope_params(100, 72)
    cfg = sv.planes_config(zs, O, slopes, width=100, height=72, n_planes=48,
                           plane_chunk=ck_stride)
    bitmap = sk.ess_bitmap(sk.ess_plane_stats(planes), zs, O, slopes,
                           _band_lut(), 0.0, 1.0, width=100, height=72,
                           ny=24, nx=24, plane_chunk=ck_stride)
    assert bool((bitmap == 0).any()), "vacuous: nothing culled"
    args = (planes, None, torch.tensor(_band_lut(), device=dev),
            torch.tensor(0.8, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    ess_cfg = dataclasses.replace(cfg, ess=bitmap)
    seed = _frozen_seed(sv.sweep_fwd(cfg, *args))
    for c, acc0 in ((ess_cfg, None), (cfg, seed)):
        got = [sv.sweep_fwd_ckpt(c, *args, acc0, staged=s) for s in (True,
                                                                   False)]
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])
        assert torch.equal(sv.sweep_fwd(c, *args, acc0, staged=True),
                           sv.sweep_fwd(c, *args, acc0, staged=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_k1_k2_are_bitwise_direct(dev, dtype):
    """The public K1 and K2 wrappers on either path: bitwise equal images,
    counted in ``.staged_launches``."""
    vol = torch.from_numpy(gaussian_blob_volume((16, 24, 20))).to(dev, dtype)
    hist = torch.from_numpy(_smooth_hist((16, 8, 24, 24), seed=2)).to(
        dev, dtype)
    rows, _ = sk.decode_weight_rows("var", 8, family="unit")
    k1, k2 = sk.sweep_preblended_planes, sk.pallas_hist_render
    out = {}
    for staged in (True, False):
        before = (k1.staged_launches, k2.staged_launches)
        with sk._fetch_path(staged):
            out[staged] = (
                sk.pallas_slice_render(vol, O, TF, 0.8, width=100, height=72,
                                       n_planes=32),
                k2(hist, rows, O, TF, 0.8, width=136, height=96, stat="var",
                   transfer_scale=10.0))
        assert (k1.staged_launches, k2.staged_launches) == (
            before[0] + staged, before[1] + staged)
    torch.cuda.synchronize()
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.parametrize("kind", ["none", "linear", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", SIZES)
def test_staged_k5_matches_direct(dev, kind, dtype, size):
    """K5 on the staged path against the direct path on the same inputs:
    LUT and parameter cotangents bitwise equal (the same per-ray sums in
    the same blocks), d_planes (or d_dec), S and the variance moments within
    1e-6 relative L2 (d_planes: atomics in another order). A seeded sweep
    gives S."""
    cfg, vol, rows = _case(dev, kind, dtype, size)
    scal = _scalars(dev, kind)
    args = (vol, rows, *scal)
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    seed = _frozen_seed(0.5 * img) if min(size) > 12 else None
    if seed is not None:
        img, tck = sv.sweep_fwd_ckpt(cfg, *args, seed)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(dev)
    before = sv.sweep_bwd.staged_launches
    got = {s: sv.sweep_bwd(cfg, *args, g, tck, True, True, True, acc0=seed,
                           staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert sv.sweep_bwd.staged_launches == before + 1
    (d_s, small_s, mom_s, s_s), (d_d, small_d, mom_d, s_d) = (got[True],
                                                              got[False])
    assert torch.equal(small_s, small_d)
    assert float(d_d.abs().max()) > 0.0, "vacuous: zero cotangent"
    assert _rel_l2(d_s, d_d) <= 1e-6
    if kind == "var":
        assert _rel_l2(mom_s, mom_d) <= 1e-6
    if seed is not None:
        assert _rel_l2(s_s, s_d) <= 1e-6


def test_k5_on_scalar_planes_defaults_to_direct(dev):
    """By default K5 stages only the decode modes: on scalar planes it takes
    the direct path (measured faster there), unless a path is forced."""
    for kind, staged in (("none", 0), ("linear", 1)):
        cfg, vol, rows = _case(dev, kind, torch.float32, (100, 72))
        args = (vol, rows, *_scalars(dev, kind))
        img, tck = sv.sweep_fwd_ckpt(cfg, *args)
        g = (2.0 / img.numel()) * (img - 0.25)
        before = sv.sweep_bwd.staged_launches
        sv.sweep_bwd(cfg, *args, g, tck, True, False, False)
        assert sv.sweep_bwd.staged_launches == before + staged, kind
        with sk._fetch_path(True):
            sv.sweep_bwd(cfg, *args, g, tck, True, False, False)
        assert sv.sweep_bwd.staged_launches == before + staged + 1, kind


def test_staged_k5_lut_cotangents_are_reproducible(dev):
    """Two staged K5 runs give bitwise equal LUT and parameter cotangents."""
    cfg, vol, rows = _case(dev, "var", torch.float32, (136, 96))
    args = (vol, rows, *_scalars(dev, "var"))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    g = (2.0 / img.numel()) * (img - 0.25)
    runs = [sv.sweep_bwd(cfg, *args, g, tck, True, True, True, staged=True)
            for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert float(runs[0][1].abs().max()) > 0.0


def test_footprint_past_the_budget_takes_the_direct_path(dev):
    """An image much coarser than the volume: the footprint's tile does not
    fit the staged budget, so the launch goes direct (``.staged_launches``
    unchanged) and is still right; forcing the staged path raises."""
    planes = torch.from_numpy(gaussian_blob_volume((8, 512, 512), seed=1)).to(
        dev)
    zs = np.linspace(0.875, -0.875, 8).astype(np.float32)
    slopes = sk.pixel_slope_params(16, 16)
    cfg = sv.planes_config(zs, O, slopes, width=16, height=16, n_planes=8)
    args = (planes, None, torch.tensor(TF, device=dev),
            torch.tensor(0.8, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    bound = sk.stage_bound(cfg.params(planes, None, 0.8, 0.0, 1.0), zs,
                           (32, 8))
    assert sk.stage_smem_bytes(*bound, n_bins=1, elem_size=4, n_lut=9,
                               row_floats=0) > sk._STAGE_BUDGET
    before = (sv.sweep_fwd.launches, sv.sweep_fwd.staged_launches)
    got = sv.sweep_fwd(cfg, *args)
    assert (sv.sweep_fwd.launches, sv.sweep_fwd.staged_launches) == (
        before[0] + 1, before[1])
    _close(got, sv.sweep_fwd_reference(cfg, *[a if a is None else a.cpu()
                                              for a in args]).to(dev))
    with pytest.raises(ValueError, match="shared memory"):
        sv.sweep_fwd(cfg, *args, staged=True)
