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
from vrdd_tpu_torch.kernels import launch
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.kernels import slice_vjp as sv
from vrdd_tpu_torch.march.slice import slice_render_image
from vrdd_tpu_torch.utils.compare import storage_ulp

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
    """K1 with ESS, tested in the kernel, is bitwise K1 without it (culled
    samples have alpha exactly 0), at images unaligned to the 32 x 8 tile;
    it launches no bitmap kernel; and it matches the plain version given
    the bitmap of the same test. n_planes == nz is the pure-selection
    schedule (cached stats), 2 nz the pre-blend."""
    k1 = sk.sweep_preblended_planes
    lut, toff, tscl = ESS_LUTS[lut_name]
    vol = _sparse_blob(dev)
    W, H = size
    kw = dict(width=W, height=H, n_planes=n_planes, transfer_offset=toff,
              transfer_scale=tscl)
    plain_k1 = sk.pallas_slice_render(vol, O, lut, 0.8, **kw)
    before = (k1.launches, k1.ess_launches, sk.ess_bitmap.launches)
    got = sk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                 **kw)
    stats = sk.precompute_ess_stats(vol, n_planes=n_planes)
    cached = sk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                    ess_stats=stats, **kw)
    torch.cuda.synchronize()
    assert (k1.launches, k1.ess_launches, sk.ess_bitmap.launches) == (
        before[0] + 2, before[1] + 2, before[2])
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
@pytest.mark.parametrize("staged", [True, False])
def test_k3_k4_ess_are_bitwise(dev, lut_name, ck_stride, staged):
    """K3's image and K4's image, every checkpoint row and the live map
    with ESS tested in the kernel are bitwise those without ESS, on either
    fetch path; the bits K3 and K4 tested are the plain version's and the
    bitmap kernel's."""
    import dataclasses

    lut, toff, tscl = ESS_LUTS[lut_name]
    vol = _sparse_blob(dev)
    planes, zs = sk.preblend_planes(vol, 48, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    slopes = sk.pixel_slope_params(100, 72)
    cfg = sv.planes_config(zs, O, slopes, width=100, height=72, n_planes=48,
                           plane_chunk=ck_stride)
    test = sk._resolve_ess(
        True, None, planes, zs, O, slopes, lut, toff, tscl, width=100,
        height=72, plane_chunk=ck_stride, march=sk.MarchConfig(),
        tex_offset=0.5, axis_scale=(1.0, 1.0), reverse_planes=False)
    assert isinstance(test, sk.EssTest)
    bitmap = sk.ess_bitmap(sk.ess_plane_stats(planes), zs, O, slopes, lut,
                           toff, tscl, width=100, height=72, ny=24, nx=24,
                           plane_chunk=ck_stride)
    args = (planes, None, torch.tensor(lut, device=dev),
            torch.tensor(0.8, device=dev), torch.tensor(toff, device=dev),
            torch.tensor(tscl, device=dev))
    k3, k4 = {}, {}
    for name, ess in (("none", None), ("test", test)):
        c = dataclasses.replace(cfg, ess=ess)
        with sk._ess_bits() as bits:
            k3[name] = sv.sweep_fwd(c, *args, staged=staged)
            k4[name] = sv.sweep_fwd_ckpt(c, *args, staged=staged,
                                         live_map=True)
        torch.cuda.synchronize()
        assert len(bits) == (2 if name == "test" else 0)
        ref = sk.ess_bitmap_reference(
            sk.ess_plane_stats(planes.cpu()), zs, O, slopes, lut, toff,
            tscl, width=100, height=72, ny=24, nx=24, plane_chunk=ck_stride)
        for got, t in bits:
            assert t is test
            assert torch.equal(got.cpu(), ref), int((got.cpu() != ref).sum())
            assert torch.equal(got, bitmap)
    assert torch.equal(k3["test"], k3["none"])
    for a, b in zip(k4["test"], k4["none"]):
        assert torch.equal(a, b)
    assert bool((bitmap == 0).any()), "vacuous: nothing culled"


def _lut256():
    """256 entries of random alpha with zero runs at both ends and one
    inside (tests/test_torch_ess_fold.py)."""
    rng = np.random.default_rng(11)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:100, 3] = 0.0
    lut[140:150, 3] = 0.0
    lut[200:, 3] = 0.0
    return lut


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n_lut", [9, 256])
@pytest.mark.parametrize("size", [(100, 72), (136, 96)])
@pytest.mark.parametrize("n_planes,chunk", [(45, 8), (48, 5)])
@pytest.mark.parametrize("staged", [True, False])
def test_in_kernel_ess_bits_equal_plain(dev, precision, n_lut, size,
                                        n_planes, chunk, staged):
    """The bits K1 tests for itself, written out through
    ``_ess_bits``, are ``ess_bitmap_reference``'s byte for byte, on both
    fetch paths, at 24^3 -> unaligned images, with a ragged last chunk
    (45 = 5 x 8 + 5) and a chunk that does not divide the staged path's
    batch of 32 planes, for 9- and 256-entry LUTs and the bf16 mode's wider
    margin; the image is bitwise the one without ESS."""
    lut = TF if n_lut == 9 else _lut256()
    W, H = size
    vol = _sparse_blob(dev)
    planes, zs = sk.preblend_planes(vol, n_planes, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    slopes = sk.pixel_slope_params(W, H)
    stats = sk.ess_plane_stats(planes)
    kw = dict(width=W, height=H, plane_chunk=chunk, precision=precision)
    with sk._fetch_path(staged), sk._ess_bits() as bits:
        got = sk.sweep_preblended_planes(planes, zs, O, slopes, lut, 0.8,
                                         empty_space_skip=True, **kw)
    with sk._fetch_path(staged):
        plain_k1 = sk.sweep_preblended_planes(planes, zs, O, slopes, lut,
                                              0.8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, plain_k1)
    assert len(bits) == 1
    margin = sk._ess_q_margin(stats, lut, 1.0, precision == "bf16")
    ref = sk.ess_bitmap_reference(
        tuple(t.cpu() for t in stats), zs, O, slopes, lut, 0.0, 1.0,
        width=W, height=H, ny=24, nx=24, plane_chunk=chunk, q_margin=margin)
    assert torch.equal(bits[0][0].cpu(), ref), int(
        (bits[0][0].cpu() != ref).sum())
    assert bool((ref == 0).any()) and bool((ref != 0).any()), "vacuous"


def test_in_kernel_ess_refuses_what_it_cannot_take(dev, monkeypatch):
    """No fallback: plane statistics of the wrong shape, a test over other
    chunks than the launch's, a precomputed bitmap in place of the test and
    a test on a decode mode raise in the wrapper, and a test geometry that
    disagrees with the launch is refused by the kernel's entry point
    (cudaErrorInvalidValue)."""
    import dataclasses

    planes, zs, slopes = _stack(dev)
    test = sk._resolve_ess(
        True, None, planes, zs, O, slopes, TF, 0.0, 1.0, width=100,
        height=72, plane_chunk=8, march=sk.MarchConfig(), tex_offset=0.5,
        axis_scale=(1.0, 1.0), reverse_planes=False)
    params = sk._sweep_params(
        O, slopes, 0.8, 1.0, 0.0, 1.0, 2.0 / 48, sk.MarchConfig(),
        width=100, height=72, ny=24, nx=24, n_planes=48, n_layers=48,
        dz_sign=-1, reverse=False, length_correction=True, tex_offset=0.5,
        axis_scale=(1.0, 1.0), filter_linear=True)
    bad = dataclasses.replace(test, pmin=test.pmin[:, :4].contiguous())
    with pytest.raises(ValueError, match="ESS plane stats"):
        sk._launch(planes, "none", zs, TF, None, params, ess=bad,
                   ess_chunk=8)
    with pytest.raises(ValueError, match="chunks"):
        sk._launch(planes, "none", zs, TF, None, params, ess=test,
                   ess_chunk=4)  # the test's chunk is 8
    with pytest.raises(TypeError, match="EssTest"):
        sk._launch(planes, "none", zs, TF, None, params, ess=test.bitmap(),
                   ess_chunk=8)
    with pytest.raises(ValueError, match="scalar plane"):
        sk._launch(planes, "linear", zs, TF, None, params, ess=test,
                   ess_chunk=8)
    ess_params = sk._ess_params

    def other_tile(*a):
        e = ess_params(*a)
        e.tile_w = 16
        return e

    monkeypatch.setattr(sk, "_ess_params", other_tile)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._launch(planes, "none", zs, TF, None, params, ess=test,
                   ess_chunk=8)


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
        k1 = sk.sweep_preblended_planes
        before = (k1.launches, k1.ess_launches, sk.ess_bitmap.launches)
        got = p.render(None, cfg, "auto")
        assert (k1.launches, k1.ess_launches, sk.ess_bitmap.launches) == (
            before[0] + 1, before[1] + 1, before[2])
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
    test = sk._resolve_ess(
        True, None, planes, zs, O, slopes, TF, 0.0, 1.0, width=100,
        height=72, plane_chunk=8, march=sk.MarchConfig(), tex_offset=0.5,
        axis_scale=(1.0, 1.0), reverse_planes=False)
    params = sk._sweep_params(
        O, slopes, 0.8, 1.0, 0.0, 1.0, 2.0 / 48, sk.MarchConfig(),
        width=100, height=72, ny=24, nx=24, n_planes=48, n_layers=48,
        dz_sign=-1, reverse=False, length_correction=True, tex_offset=0.5,
        axis_scale=(1.0, 1.0), filter_linear=True)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sk._launch(planes, "none", zs, TF, None, params, ess=test,
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
    """With ESS tested in the kernel (culled chunks skip their planes), and
    from a seed with frozen pixels, the staged K1/K3/K4 images and
    checkpoints are bitwise the direct ones."""
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
    ess_cfg = dataclasses.replace(cfg, ess=sk._resolve_ess(
        True, None, planes, zs, O, slopes, _band_lut(), 0.0, 1.0, width=100,
        height=72, plane_chunk=ck_stride, march=sk.MarchConfig(),
        tex_offset=0.5, axis_scale=(1.0, 1.0), reverse_planes=False))
    seed = _frozen_seed(sv.sweep_fwd(cfg, *args))
    for c, acc0 in ((ess_cfg, None), (cfg, seed)):
        got = [sv.sweep_fwd_ckpt(c, *args, acc0, staged=s) for s in (True,
                                                                   False)]
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])
        assert torch.equal(sv.sweep_fwd(c, *args, acc0, staged=True),
                           sv.sweep_fwd(c, *args, acc0, staged=False))
    k1 = {}
    for staged in (True, False):
        with sk._fetch_path(staged):
            k1[staged] = sk.sweep_preblended_planes(
                planes, zs, O, slopes, _band_lut(), 0.8, width=100,
                height=72, plane_chunk=ck_stride, empty_space_skip=True)
    assert torch.equal(k1[True], k1[False])


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
@pytest.mark.parametrize("ck_stride", [4, 8])
def test_staged_k5_matches_direct(dev, kind, dtype, size, ck_stride):
    """K5 on the staged path against the direct path on the same inputs:
    LUT and parameter cotangents bitwise equal (the same per-ray sums in
    the same blocks), d_planes (or d_dec), S and the variance moments within
    1e-6 relative L2 (d_planes: atomics in another order). A seeded sweep
    gives S."""
    import dataclasses

    cfg, vol, rows = _case(dev, kind, dtype, size)
    cfg = dataclasses.replace(cfg, ck_stride=ck_stride)
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


@pytest.mark.parametrize("kind", ["none", "linear", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_footprints_past_the_bound_go_direct_mid_walk(dev, kind, dtype,
                                                      monkeypatch):
    """With the host's bound shrunk below the far planes' footprints, the
    staged kernels fetch those planes directly in the middle of their walk
    (and stage the near ones): K3/K4 bitwise, K5's LUT cotangents bitwise
    and d_planes within 1e-6 of the direct path."""
    cfg, vol, rows = _case(dev, kind, dtype, (100, 72))
    args = (vol, rows, *_scalars(dev, kind))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args, staged=False)
    k3 = sv.sweep_fwd(cfg, *args, staged=False)
    g = (2.0 / img.numel()) * (img - 0.25)
    d_ref, small_ref, _, _ = sv.sweep_bwd(cfg, *args, g, tck, True, True,
                                          False, staged=False)
    bound = launch.stage_bound
    widths = []

    def shrunk(params, zs, block):
        tw, th = bound(params, zs, block)
        widths.append(tw)
        return max(tw - 3, 3), th

    monkeypatch.setattr(launch, "stage_bound", shrunk)
    got3 = sv.sweep_fwd(cfg, *args, staged=True)
    got4 = sv.sweep_fwd_ckpt(cfg, *args, staged=True)
    d, small, _, _ = sv.sweep_bwd(cfg, *args, g, tck, True, True, False,
                                  staged=True)
    torch.cuda.synchronize()
    assert min(widths) > 6, "vacuous: the near planes would not stage"
    assert torch.equal(got3, k3)
    assert torch.equal(got4[0], img) and torch.equal(got4[1], tck)
    assert torch.equal(small, small_ref)
    assert _rel_l2(d, d_ref) <= 1e-6


@pytest.mark.parametrize("shape", [(12, 8, 20, 26), (10, 4, 17, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_unaligned_rows_are_bitwise_direct(dev, shape, dtype):
    """Rows that are not whole 16-byte multiples start at their own
    16-byte phase in the copies' issue: K4 bitwise, K5 within its limits of
    the direct path."""
    hist = torch.from_numpy(_smooth_hist(shape, seed=4)).to(dev, dtype)
    rows, _ = sk.decode_weight_rows("var", shape[1], family="unit")
    cfg = sv.render_config(hist.shape, O, stat="var", width=100, height=72)
    args = (hist, torch.as_tensor(rows, device=dev), *_scalars(dev, "var"))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args, staged=False)
    g = (2.0 / img.numel()) * (img - 0.25)
    d_ref, small_ref, mom_ref, _ = sv.sweep_bwd(cfg, *args, g, tck, True,
                                                True, False, staged=False)
    before = (sv.sweep_fwd_ckpt.staged_launches, sv.sweep_bwd.staged_launches)
    got = sv.sweep_fwd_ckpt(cfg, *args, staged=True)
    d, small, mom, _ = sv.sweep_bwd(cfg, *args, g, tck, True, True, False,
                                    staged=True)
    torch.cuda.synchronize()
    assert (sv.sweep_fwd_ckpt.staged_launches, sv.sweep_bwd.staged_launches) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], img) and torch.equal(got[1], tck)
    assert torch.equal(small, small_ref)
    assert _rel_l2(d, d_ref) <= 1e-6 and _rel_l2(mom, mom_ref) <= 1e-6


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
    bound = launch.stage_bound(cfg.params(planes, None, 0.8, 0.0, 1.0), zs,
                               (32, 8))
    assert launch.stage_smem_bytes(*bound, n_bins=1, elem_size=4, n_lut=9,
                                   row_floats=0) > launch._STAGE_BUDGET
    before = (sv.sweep_fwd.launches, sv.sweep_fwd.staged_launches)
    got = sv.sweep_fwd(cfg, *args)
    assert (sv.sweep_fwd.launches, sv.sweep_fwd.staged_launches) == (
        before[0] + 1, before[1])
    _close(got, sv.sweep_fwd_reference(cfg, *[a if a is None else a.cpu()
                                              for a in args]).to(dev))
    with pytest.raises(ValueError, match="shared memory"):
        sv.sweep_fwd(cfg, *args, staged=True)


# ---- the flexible-block grid and fit-tf on the card ------------------------

def _flex_pipeline(dev):
    """A RenderPipeline over a 13 x 11 x 7-block (x, y, z) flexible grid
    (``from_raw`` of a smooth 39 x 33 x 21 volume on the card, blocks of
    3), normalized: its padded 14-wide rows are 56 bytes, not a multiple of
    16, and its filter grid is scaled (13/14, 11/12, 7/8)."""
    from vrdd_tpu_torch.models.flexible import FlexibleBlockVolume
    from vrdd_tpu_torch.models.pipeline import RenderPipeline

    raw = gaussian_blob_volume((21, 33, 39), seed=3, device=dev) * 255.0
    flex = FlexibleBlockVolume.from_raw(raw, block_size=3, vmax=256.0)
    assert flex.n_blocks == (7, 11, 13)
    return RenderPipeline(flexible=flex.normalized())


@pytest.mark.parametrize("query", [8, 9, 0])
def test_flex_k1_with_ess_z_scale_on_an_unaligned_grid(dev, query):
    """Queries 8/9/0 through 'auto': K1 with ESS (plane stats at z scale
    7/8), staged bitwise direct, ESS bitwise no ESS, within the image
    tolerance of the plain 'slice' renderer."""
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig)

    p = _flex_pipeline(dev)
    cfg = RenderConfig(camera=CameraConfig(width=100, height=72),
                       density=0.5, query_method=QueryMethod(query))
    k1 = sk.sweep_preblended_planes
    iv = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]], np.float32)
    assert p.resolve_renderer("auto", iv, cfg) == "pallas"
    vol = p._stats_channel(query)
    assert tuple(vol.shape) == (8, 12, 14)
    assert p._flex_axis_scale(query) == (13 / 14, 11 / 12, 7 / 8)
    before = (k1.launches, k1.ess_launches, k1.staged_launches)
    got = p.render(None, cfg, "auto")
    torch.cuda.synchronize()
    assert (k1.launches, k1.ess_launches, k1.staged_launches) == tuple(
        b + 1 for b in before)
    assert [k[3] for k in p._ess_cache] == [7 / 8]
    with sk._fetch_path(False):
        assert torch.equal(p.render(None, cfg, "auto"), got)
    p.empty_space_skip = False
    assert torch.equal(p.render(None, cfg, "pallas"), got)
    assert float(got[..., 3].max()) > 0.0
    _close(got, p.render(None, cfg, "slice"))


def test_flex_shearwarp_k3_permuted_axis_scale(dev):
    """A rotated flex view through 'auto', for the three principal axes:
    shear-warp on K3 with the permuted filter-grid scales, against the same
    path's plain versions on the CPU (the 'xla' backend samples another
    m-grid, which differs at this image size)."""
    from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
    from vrdd_tpu_torch.march.shearwarp import shearwarp_render_image
    from vrdd_tpu_torch.utils.config import (
        CameraConfig, QueryMethod, RenderConfig)

    p = _flex_pipeline(dev)
    cfg = RenderConfig(camera=CameraConfig(width=96, height=80), density=0.5,
                       query_method=QueryMethod.FLEX_MEAN)
    for view in ((30.0, 20.0), (0.0, 60.0), (60.0, 0.0)):
        iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
        assert p.resolve_renderer("auto", iv, cfg) == "shearwarp"
        before = sv.sweep_fwd.launches
        got = p.render(iv, cfg, "auto")
        torch.cuda.synchronize()
        assert sv.sweep_fwd.launches == before + 1
        vol = p._stats_channel(QueryMethod.FLEX_MEAN)
        ref = shearwarp_render_image(
            vol.cpu(), iv, 96, 80, p.tf_lut.cpu(), 0.5, n_planes=64,
            axis_scale=p._flex_axis_scale(QueryMethod.FLEX_MEAN),
            backend="pallas")
        assert float(ref[..., 3].max()) > 0.05, "vacuous: empty render"
        _close(got, ref.to(dev))


def test_fit_tf_lut_k4_k5_match_plain(dev):
    """fit-tf's loss on the card (K3 for the target, K4 + K5 with
    wrt=('lut',) per step) against the plain sweep's on the same stats:
    loss within 1e-5 relative, LUT gradient within 1e-3 relative L2."""
    from vrdd_tpu_torch.cli import fit_tf_problem
    from vrdd_tpu_torch.core.transfer import grayscale_ramp
    from vrdd_tpu_torch.io.synthetic import random_histogram_volume
    from vrdd_tpu_torch.models.volumes import RawHistogramVolume

    hist = random_histogram_volume((10, 50, 50), n_bins=32, seed=0)
    stats = RawHistogramVolume(torch.from_numpy(hist).to(dev)).stats_volume()
    out = {}
    counters = (sv.sweep_fwd, sv.sweep_fwd_ckpt, sv.sweep_bwd)
    for renderer in ("pallas", "slice"):
        before = [c.launches for c in counters]
        loss_fn, name = fit_tf_problem(stats, 136, 100, renderer)
        lut = torch.tensor(grayscale_ramp(9), device=dev, requires_grad=True)
        loss = loss_fn(lut)
        (g,) = torch.autograd.grad(loss, [lut])
        torch.cuda.synchronize()
        out[renderer] = (float(loss.detach()), g)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([1, 1, 1] if renderer == "pallas" else [0, 0, 0])
    assert fit_tf_problem(stats, 136, 100, "auto")[1] == "pallas"
    assert abs(out["pallas"][0] - out["slice"][0]) <= 1e-5 * out["slice"][0]
    assert _rel_l2(out["pallas"][1], out["slice"][1]) <= 1e-3


# ---- the distributed sweep (parallel/) -------------------------------------

def _from_below(dev, dtype, kind, W, H, ck_stride=4):
    """A histogram sweep looking up the z axis: camera at z = -4, d_z > 0,
    the slab walked in storage order (dz_sign=+1, reverse_planes=False), as
    every shear-warp view whose principal axis points away from the camera
    gives it."""
    stat = {"linear": "mean", "var": "var", "entropy": "entropy"}[kind]
    rows, _ = sk.decode_weight_rows(stat, 8, family="unit")
    hist = torch.from_numpy(_smooth_hist((16, 8, 24, 20), seed=4)).to(
        dev, dtype)
    zs = (-1.0 + 2.0 / 16 * (np.arange(16, dtype=np.float32) + 0.5))
    cfg = sv.hist_config(zs, (0.0, 0.0, -4.0), sk.pixel_slope_params(W, H),
                         stat=kind, dz_sign=1, width=W, height=H,
                         plane_chunk=ck_stride, reverse_planes=False)
    return cfg, hist, torch.as_tensor(rows, device=dev)


@pytest.mark.parametrize("kind", ["linear", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hist_dz_plus_k3_k4_k5_match_plain_and_paths(dev, kind, dtype):
    """Hist-mode K3/K4/K5 at dz_sign=+1, reverse_planes=False, 100 x 70:
    K4's image bitwise K3's; K3 and K4 staged bitwise direct; each against
    its plain version (image tolerance, K5's d_dec and LUT cotangents 1e-3
    relative L2); K5's LUT cotangents bitwise across the paths."""
    cfg, hist, rows = _from_below(dev, dtype, kind, 100, 70)
    args = (hist, rows, *_scalars(dev, kind))
    cpu = tuple(a.cpu() for a in args)
    k3 = {s: sv.sweep_fwd(cfg, *args, staged=s) for s in (True, False)}
    k4 = {s: sv.sweep_fwd_ckpt(cfg, *args, staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert float(k3[True][..., 3].max()) > 0.05, "vacuous: empty render"
    for s in (True, False):
        assert torch.equal(k4[s][0], k3[s])
    assert torch.equal(k3[True], k3[False])
    assert torch.equal(k4[True][1], k4[False][1])
    ref_img, ref_tck = sv.sweep_fwd_ckpt_reference(cfg, *cpu)
    _close(k3[True], ref_img.to(dev))
    _close(k4[True][1][..., None], ref_tck[..., None].to(dev))
    g = torch.randn((70, 100, 4), generator=torch.Generator().manual_seed(2))
    k5 = {s: sv.sweep_bwd(cfg, *args, g.to(dev), k4[s][1], True, True, True,
                          staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert torch.equal(k5[True][1], k5[False][1])
    d_r, small_r, _, _ = sv.sweep_bwd_reference(cfg, *cpu, g, True, True,
                                                True)
    for d, small, _, _ in k5.values():
        assert _rel_l2(d, d_r) <= 1e-3 and _rel_l2(small, small_r) <= 1e-3


@pytest.mark.parametrize("kind", ["none", "linear"])
@pytest.mark.parametrize("staged", [True, False])
def test_seeds_frozen_at_alpha_2(dev, kind, staged):
    """Pass 2 of the distributed sweep seeds every pixel outside the
    crossing slab at alpha 2: K3 and K4 leave it at its seed, K4's
    checkpoints hold T0 = -1, K5 reports S = 0 there, and its seed
    cotangent is (g_rgb, g_a); live pixels resume against the plain
    version."""
    cfg, vol, rows = _case(dev, kind, torch.float32, (100, 70))
    args = (vol, rows, *_scalars(dev, kind))
    front = sv.sweep_fwd(cfg, *args)
    seed = torch.zeros_like(front)
    seed[..., 3] = 2.0
    live = torch.zeros(front.shape[:2], dtype=torch.bool, device=dev)
    live[20:45:3, 5:90:7] = True
    seed = torch.where(live[..., None], 0.5 * front, seed)
    with sk._fetch_path(staged):
        img = sv.sweep_fwd(cfg, *args, seed)
        img4, tck = sv.sweep_fwd_ckpt(cfg, *args, seed)
        g = torch.randn(img.shape, generator=torch.Generator().manual_seed(4))
        _, _, _, s_img = sv.sweep_bwd(cfg, *args, g.to(dev), tck, True, True,
                                      False, acc0=seed)
    torch.cuda.synchronize()
    assert torch.equal(img[~live], seed[~live])
    assert torch.equal(img4, img)
    assert bool((tck[:, ~live] == -1.0).all())
    assert bool((s_img[~live] == 0.0).all())
    cpu = tuple(None if a is None else a.cpu() for a in args)
    _close(img, sv.sweep_fwd_reference(cfg, *cpu, seed.cpu()).to(dev))
    s_ref = sv.sweep_bwd_reference(cfg, *cpu, g, True, True, False,
                                   seed.cpu())[3]
    assert _rel_l2(s_img, s_ref) <= 1e-3
    d_acc0 = sv._seed_cotangent(g.to(dev), seed, s_img)
    assert torch.equal(d_acc0[~live], g.to(dev)[~live])


@pytest.mark.parametrize("kind", ["none", "entropy"])
def test_row_strip_slopes(dev, kind):
    """A ray strip of the distributed sweep: rows 13 .. 50 of a 100 x 72
    image (my_local[0] != my[0], a height of 37, not a multiple of 8) swept
    with slopes (mx0, dmx, my_local[0], dmy): close to those rows of the
    whole image, against its plain version, staged bitwise direct."""
    import dataclasses

    from vrdd_tpu_torch.parallel.sweep import _strip_slopes

    cfg, vol, rows = _case(dev, kind, torch.float32, (100, 72))
    mx, my = sk._slope_grids(cfg.slopes, 100, 72)
    strip = dataclasses.replace(cfg, height=37,
                                slopes=_strip_slopes(mx, my[13:50]))
    assert strip.slopes[2] != cfg.slopes[2]
    args = (vol, rows, *_scalars(dev, kind))
    whole = sv.sweep_fwd(cfg, *args)
    got = {s: sv.sweep_fwd(strip, *args, staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert torch.equal(got[True], got[False])
    _close(got[True], whole[13:50])
    cpu = tuple(None if a is None else a.cpu() for a in args)
    _close(got[True], sv.sweep_fwd_reference(strip, *cpu).to(dev))


@pytest.mark.parametrize("density", [0.3, 5.0])
def test_three_bricks_two_rays_match_the_unsharded_call(dev, density):
    """distributed_hist_render and distributed_sweep_render on bricks=3 x
    rays=2 on one card (strips of 47 rows) against the single-device
    kernels; the hist render's d_hist and LUT cotangents against
    pallas_hist_render_diff's (1e-3 relative L2). Density 5 saturates, so
    pass 2 re-sweeps the crossing slabs; the strips' slopes round apart
    from the whole image's, so a few rays flip at the cutoff (the 0.1%
    budget)."""
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(3, 2)
    assert mesh.device.type == "cuda"
    hist = torch.from_numpy(_smooth_hist((12, 8, 20, 24), seed=3)).to(dev)
    rows, _ = sk.decode_weight_rows("mean", 8, family="unit")
    W, H = 136, 94

    def close(got, ref, what):
        try:
            _close(got, ref)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None

    before = sv.sweep_fwd.launches
    img = ps.distributed_hist_render(hist, rows, O, TF, density, width=W,
                                     height=H, mesh=mesh)
    torch.cuda.synchronize()
    assert sv.sweep_fwd.launches == before + 12  # 6 shards, two passes
    close(img, sk.pallas_hist_render(hist, rows, O, TF, density, width=W,
                                     height=H), "hist vs K2")
    vol = torch.from_numpy(gaussian_blob_volume((12, 20, 24), seed=3)).to(dev)
    img = ps.distributed_sweep_render(vol, O, TF, density, width=W,
                                      height=H, mesh=mesh)
    close(img, ps.distributed_sweep_render(vol, O, TF, density, width=W,
                                           height=H,
                                           mesh=make_mesh(1, 1)),
          "scalar vs one shard")
    # JAX's construction steps a shard's slopes by the float32 difference
    # of two grid points; K1 takes the grid's mean spacing. At density 5
    # the two round across the cutoff on 0.13% of these rays (the plain
    # versions too), by less than 1e-3
    k1 = sk.pallas_slice_render(vol, O, TF, density, width=W, height=H)
    assert float((img - k1).abs().max()) < 1e-3
    out = []
    for fn in (lambda h, lut: ps.distributed_hist_render(
                   h, rows, O, lut, density, width=W, height=H, mesh=mesh,
                   wrt=("hist", "lut")),
               lambda h, lut: sv.pallas_hist_render_diff(
                   h, rows, O, lut, density, width=W, height=H,
                   wrt=("hist", "lut"))):
        leaves = [hist.clone().requires_grad_(),
                  torch.tensor(TF, device=dev, requires_grad=True)]
        out.append(_grads(fn, leaves))
    (img_d, (gh, gl)), (img_s, (gh_s, gl_s)) = out
    close(img_d.detach(), img_s.detach(), "hist under autograd vs K4")
    assert _rel_l2(gh, gh_s) <= 1e-3 and _rel_l2(gl, gl_s) <= 1e-3


@pytest.mark.parametrize("view", [(30.0, 20.0), (0.0, 60.0), (60.0, 0.0)])
def test_distributed_shearwarp_hist_matches_plain(dev, view):
    """The rotated distribution-native frame on bricks=2 x rays=2 on the
    card against the same call on the CPU (the kernels' plain versions)."""
    from vrdd_tpu_torch.core.geometry import (
        inv_view_from_rotation_translation)
    from vrdd_tpu_torch.parallel import sweep as ps
    from vrdd_tpu_torch.parallel.mesh import make_mesh

    iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
    h = _smooth_hist((12, 8, 20, 24), seed=5)
    rows, _ = sk.decode_weight_rows("mean", 8, family="unit")
    imgs = [ps.distributed_shearwarp_hist_render(
        torch.from_numpy(h).to(d), rows, iv, 60, 44, TF, 0.3,
        mesh=make_mesh(2, 2, devices=[d]), oversample=1.0)
        for d in (dev, "cpu")]
    ps.clear_octant_cache()
    assert float(imgs[1][..., 3].max()) > 0.05, "vacuous: empty render"
    _close(imgs[0], imgs[1].to(dev))


# ---- precision='bf16', the y-transpose kernel and K4's live map -------------

@pytest.mark.parametrize("kind", ["none", "linear", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", SIZES)
def test_bf16_k3_k4_staged_are_bitwise_direct(dev, kind, dtype, size):
    """In the bf16 mode the staged K3/K4 images and checkpoints are bitwise
    the direct ones, differ from the f32 image (the mode is no no-op), and
    match the plain bf16 version; ``.bf16_launches`` counts."""
    import dataclasses

    cfg, vol, rows = _case(dev, kind, dtype, size)
    cfg16 = dataclasses.replace(cfg, precision="bf16")
    args = (vol, rows, *_scalars(dev, kind))
    before = (sv.sweep_fwd.bf16_launches, sv.sweep_fwd_ckpt.bf16_launches)
    k3 = {s: sv.sweep_fwd(cfg16, *args, staged=s) for s in (True, False)}
    k4 = {s: sv.sweep_fwd_ckpt(cfg16, *args, staged=s) for s in (True, False)}
    torch.cuda.synchronize()
    assert (sv.sweep_fwd.bf16_launches, sv.sweep_fwd_ckpt.bf16_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(k3[True], k3[False])
    assert torch.equal(k4[True][0], k4[False][0])
    assert torch.equal(k4[True][1], k4[False][1])
    assert torch.equal(k4[True][0], k3[True])
    assert not torch.equal(k3[True], sv.sweep_fwd(cfg, *args))
    _close(k3[True], sv.sweep_fwd_reference(cfg16, *args))


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_k2_matches_plain(dev, stat, dtype):
    hist = torch.from_numpy(_smooth_hist((16, 8, 24, 24), seed=2)).to(
        dev, dtype)
    rows, mode = sk.decode_weight_rows(stat, 8, family="unit")
    kw = dict(transfer_scale=10.0 if stat == "var" else 1.0, width=100,
              height=72, stat=mode, precision="bf16")
    before = sk.pallas_hist_render.bf16_launches
    got = sk.pallas_hist_render(hist, rows, O, TF, 0.8, **kw)
    assert sk.pallas_hist_render.bf16_launches == before + 1
    _close(got, sk.hist_render_reference(hist, rows, O, TF, 0.8, **kw))


@pytest.mark.parametrize("kind", ["none", "linear", "var", "entropy"])
@pytest.mark.parametrize("staged", [True, False])
def test_bf16_k5_matches_plain(dev, kind, staged):
    """The bf16 K5 (row buffer) and the y-transpose kernel against the plain
    bf16 backward (JAX's transpose): 1e-3 relative L2, and at most 8% of
    the plane cotangent's nonzero entries off by more than 2^-12 of the
    entry (chip_smoke.py's BF16_SHARE_LIMIT, set from its 12b readings at
    the main path's shape: the kernel 1.0e-4 and 0.11%, a skipped rounding
    1.4e-3 and 33% or more); staged against direct: LUT cotangents
    bitwise, plane cotangents within 1e-6 relative L2."""
    import dataclasses

    cfg, vol, rows = _case(dev, kind, torch.float32, (100, 72))
    cfg = dataclasses.replace(cfg, precision="bf16")
    args = (vol, rows, *_scalars(dev, kind))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args)
    g = (2.0 / img.numel()) * (img - 0.25)
    before = (sv.sweep_bwd.bf16_launches, sv.dplane_bf16.launches)
    d, small, *_ = sv.sweep_bwd(cfg, *args, g, tck, True, True, False,
                                staged=staged)
    assert (sv.sweep_bwd.bf16_launches, sv.dplane_bf16.launches) == (
        before[0] + 1, before[1] + 1)
    d_r, small_r, *_ = sv.sweep_bwd_reference(cfg, *args, g, True, True,
                                              False)
    assert float(d_r.abs().max()) > 0.0, "vacuous: zero cotangent"
    assert _rel_l2(d, d_r) <= 1e-3
    assert _rel_l2(small, small_r) <= 1e-3
    nz = d_r != 0
    share = float(((d - d_r).abs() > 2.0 ** -12 * d_r.abs())[nz].float()
                  .mean())
    assert share <= 0.08, share
    other = sv.sweep_bwd(cfg, *args, g, tck, True, True, False,
                         staged=not staged)
    assert torch.equal(small, other[1])
    assert _rel_l2(d, other[0]) <= 1e-6


@pytest.mark.parametrize("staged", [True, False])
def test_k5_lut_slope_at_a_knot(dev, staged):
    """Constant 0.5 planes put the samples on the TF's knot q = 4: K5 takes
    JAX's slope there, the knot interval below (as the plain version does),
    on a LUT whose slopes change at every knot: plane, LUT and parameter
    cotangents within 1e-5 relative L2 of the plain version's."""
    _, zs = sk.preblend_planes(torch.zeros(24, 24, 24), 48, (-1.0, -1.0, -1.0),
                               (1.0, 1.0, 1.0), -1)
    cfg = sv.planes_config(zs, O, sk.pixel_slope_params(100, 72), width=100,
                           height=72, n_planes=48)
    ramp = torch.tensor([0.0, 0.1, 0.3, 0.6, 1.0, 0.9, 0.5, 0.2, 0.0])
    lut = torch.stack([ramp, ramp.flip(0), ramp ** 2, 0.1 + 0.5 * ramp],
                      -1).to(dev)
    args = (torch.full((48, 24, 24), 0.5, device=dev), None, lut,
            torch.tensor(0.3, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args, staged=staged)
    g = (2.0 / img.numel()) * (img - 0.25)
    d, small, *_ = sv.sweep_bwd(cfg, *args, g, tck, True, True, True,
                                staged=staged)
    d_r, small_r, *_ = sv.sweep_bwd_reference(cfg, *args, g, True, True, True)
    assert float(d_r.abs().max()) > 0.0, "vacuous: zero cotangent"
    assert _rel_l2(d, d_r) <= 1e-5
    assert _rel_l2(small, small_r) <= 1e-5


@pytest.mark.parametrize("staged", [True, False])
def test_k4_k5_freeze_at_jax_threshold(dev, staged):
    """K4 and K5 freeze a ray where JAX and the plain versions do: once T <
    f32(1 - 0.95). At alpha 0.20581666 a sample (constant planes, the LUT's
    top knot opaque, no length correction) the 13th step lands T three ulps
    or less below 1.0f - 0.95f but not below f32(1 - 0.95) (found by running
    the recursion on the host), so the ray takes a 14th step: checkpoints
    bitwise the plain version's, LUT cotangents within 1e-5 relative L2."""
    density = float(np.float32(0.20581666))
    _, zs = sk.preblend_planes(torch.zeros(48, 8, 8), 48, (-1.0, -1.0, -1.0),
                               (1.0, 1.0, 1.0), -1)
    cfg = sv.planes_config(zs, O, sk.pixel_slope_params(20, 12), width=20,
                           height=12, n_planes=48, length_correction=False)
    lut = torch.zeros((8, 4), device=dev)
    lut[7] = torch.tensor([0.8, 0.5, 0.2, 1.0])
    args = (torch.full((48, 8, 8), 10.0, device=dev), None, lut,
            torch.tensor(density, device=dev), torch.tensor(0.0, device=dev),
            torch.tensor(1.0, device=dev))
    img, tck = sv.sweep_fwd_ckpt(cfg, *args, staged=staged)
    img_r, tck_r = sv.sweep_fwd_ckpt_reference(cfg, *args)
    thr1 = np.float32(1.0 - 0.95)
    assert bool(((tck_r < thr1) & (tck_r > 0.03)).any()), "vacuous: no step"
    assert torch.equal(tck, tck_r)
    _close(img, img_r)
    g = (2.0 / img.numel()) * (img - 0.25)
    small = sv.sweep_bwd(cfg, *args, g, tck, False, True, False,
                         staged=staged)[1]
    small_r = sv.sweep_bwd_reference(cfg, *args, g, False, True, False)[1]
    assert _rel_l2(small, small_r) <= 1e-5


@pytest.mark.parametrize("kind", ["none", "linear"])
@pytest.mark.parametrize("size", [(100, 72), (20, 6), (300, 260)])
def test_dplane_bf16_kernel_matches_plain(dev, kind, size):
    """The y-transpose kernel on a random row buffer against its plain
    version (the dense bf16(wy)^T bf16(dtmp)): the same products, summed in
    another order. Stacks walked forward ('none') and reversed."""
    import dataclasses

    cfg, vol, _ = _case(dev, kind, torch.float32, size)
    cfg = dataclasses.replace(cfg, precision="bf16")
    n_layers, ny, nx = vol.shape[0], vol.shape[-2], vol.shape[-1]
    gen = torch.Generator().manual_seed(4)
    dtmp = torch.randn((len(cfg.zs), cfg.height, nx), generator=gen).to(dev)
    d = torch.full((n_layers, ny, nx), float("nan"), device=dev)
    before = sv.dplane_bf16.launches
    sv.dplane_bf16(cfg, dtmp, d)
    assert sv.dplane_bf16.launches == before + 1
    ref = sv.dplane_bf16_reference(cfg, dtmp, n_layers, ny)
    torch.cuda.synchronize()
    assert torch.isfinite(d).all(), "an output element was not written"
    assert float(ref.abs().max()) > 0.0
    assert _rel_l2(d, ref) <= 1e-6


@pytest.mark.parametrize("density", [0.05, 0.8, 5.0])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("ck_stride", [4, 8])
def test_k4_live_map_matches_plain(dev, density, staged, ck_stride):
    """K4's live map (both fetch paths) against the plain version's bytes,
    except tiles with a ray within 1e-6 of a cutoff; the image and the
    checkpoints are unchanged by asking for the map."""
    import dataclasses

    cfg, vol, _ = _case(dev, "none", torch.float32, (136, 96))
    cfg = dataclasses.replace(cfg, ck_stride=ck_stride)
    lut, dens, toff, tscl = _scalars(dev, "none")
    dens = torch.tensor(density, device=dev)
    args = (vol, None, lut, dens, toff, tscl)
    before = sv.sweep_fwd_ckpt.live_launches
    img, tck, live = sv.sweep_fwd_ckpt(cfg, *args, staged=staged,
                                       live_map=True)
    assert sv.sweep_fwd_ckpt.live_launches == before + 1
    img0, tck0 = sv.sweep_fwd_ckpt(cfg, *args, staged=staged)
    assert torch.equal(img, img0) and torch.equal(tck, tck0)
    _, _, live_r, tied = sv.sweep_fwd_ckpt_reference(cfg, *args,
                                                     live_map=True)
    torch.cuda.synchronize()
    assert live.shape == live_r.shape
    differ = (live != live_r) & (tied == 0)
    assert not bool(differ.any()), int(differ.sum())
    if density == 5.0:
        assert bool((live_r == 0).any()), "vacuous: no tile died"


def test_live_fractions_on_the_card(dev):
    vol = torch.from_numpy(gaussian_blob_volume((16, 24, 24))).to(dev)
    got = sv.live_fractions(vol, O, TF, 5.0, width=128, height=64,
                            n_planes=16)
    ref = sv.live_fractions(vol.cpu(), O, TF, 5.0, width=128, height=64,
                            n_planes=16)
    # 4 chunks x 8 x 4 tiles: at most one tile decided differently at a tie
    assert got["n_xt"] == ref["n_xt"] == 4
    for key in ("tile_live_frac", "strip_live_frac"):
        assert abs(got[key] - ref[key]) <= 1.0 / 128, key


@pytest.mark.parametrize("lut_name", sorted(ESS_LUTS))
def test_bf16_k1_ess_is_bitwise_k1(dev, lut_name):
    """In the bf16 mode the widened ESS margin keeps culling exact: K1 with
    ESS is bitwise K1 without it."""
    lut, toff, tscl = ESS_LUTS[lut_name]
    vol = _sparse_blob(dev)
    kw = dict(width=100, height=72, n_planes=48, transfer_offset=toff,
              transfer_scale=tscl, precision="bf16")
    plain_k1 = sk.pallas_slice_render(vol, O, lut, 0.8, **kw)
    got = sk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, plain_k1)
    assert float(got[..., 3].max()) > 0.05, "vacuous: empty render"


# ---- the decode's histogram cotangent (csrc/decode_chain.cu) ---------------

_CHAIN_SHAPES = [((4, 8, 6, 6), False), ((3, 8, 5, 37), False),
                 ((64, 16, 64, 64), False), ((8, 16, 16, 32), True)]


def _chain_inputs(dev, dtype, shape, chain, misalign, seed=3):
    """Smooth softmax histograms (one bin exactly empty), their decode rows,
    a seeded d_dec and, for 'var_mom', the moments K5 writes. ``misalign``
    puts d_dec 4 bytes past a 16-byte boundary (the scalar path)."""
    nz, B, ny, nx = shape
    base = gaussian_blob_volume((nz, ny, nx), seed=seed)
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    h = e / e.sum(axis=1, keepdims=True)
    h[:, B // 2] = 0.0
    hist = torch.from_numpy(h).to(dev, dtype)
    stat = {"linear": "mean", "entropy": "entropy"}.get(chain, "var")
    rows_np, mode = sk.decode_weight_rows(stat, B, family="unit")
    rows = torch.from_numpy(rows_np).to(dev)
    gen = torch.Generator().manual_seed(seed)
    d_dec = torch.randn((nz, ny, nx), generator=gen).to(dev)
    if misalign:
        buf = torch.empty(d_dec.numel() + 1, device=dev)
        buf[1:] = d_dec.reshape(-1)
        d_dec = buf[1:].view(nz, ny, nx)
    mom = None
    if chain == "var_mom":
        m, c1, _, c0 = sk._moments(hist.float(), rows)
        mom = torch.stack([m, 2.0 * (m * c0 - c1)], dim=1).contiguous()
    return hist, rows, mode, d_dec, mom


@pytest.mark.parametrize("shape,misalign", _CHAIN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["linear", "var_mom", "var", "entropy"])
def test_decode_chain_kernel_matches_plain(dev, chain, dtype, shape,
                                           misalign):
    """The chain kernel against its plain version on the card, in the
    storage dtype: linear and the variance from K5's moments bitwise (the
    same rounded operations in the same order); entropy within one storage
    rounding on at most 1e-4 of the elements, and exactly 0 at every empty
    bin; the variance from the histograms (its moments summed in bin order,
    the plain einsum's order is its own) within one storage rounding over
    the float32 noise of its cancellation (1e-5 of the largest)."""
    hist, rows, mode, d_dec, mom = _chain_inputs(dev, dtype, shape, chain,
                                                 misalign)
    got = sk.decode_chain(hist, rows, mode, d_dec, mom)
    ref = sk.decode_chain_reference(hist, rows, mode, d_dec, mom)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == hist.shape
    if chain in ("linear", "var_mom"):
        assert torch.equal(got, ref)
        return
    a, b = got.float(), ref.float()
    slack = storage_ulp(torch.maximum(a.abs(), b.abs()), dtype)
    if chain == "var":
        slack = slack + 1e-5 * float(b.abs().max())
    assert bool(((a - b).abs() <= slack).all())
    if chain == "entropy":
        assert float((a != b).float().mean()) <= 1e-4
        assert float(a[:, shape[1] // 2].abs().max()) == 0.0
        assert bool((a[hist == 0] == 0).all())


_CHAIN_FAULTS = ["float16", "strided", "d_dec_shape", "d_dec_dtype",
                 "mom_shape", "rows_device", "rows_shape", "mode"]


@pytest.mark.parametrize("fault", _CHAIN_FAULTS)
def test_decode_chain_rejects_what_it_does_not_take(dev, fault):
    """The wrapper raises on every input the kernel does not take; there is
    no torch fallback on the card. The materialized decode raises at its
    forward on a histogram volume whose gradient the kernel cannot write."""
    hist, rows, mode, d_dec, mom = _chain_inputs(dev, torch.bfloat16,
                                                 (4, 8, 6, 8), "var_mom",
                                                 False)
    if fault == "float16":
        hist = hist.to(torch.float16)
    elif fault == "strided":
        hist = torch.zeros((4, 8, 6, 16), device=dev,
                           dtype=torch.bfloat16)[..., ::2]
    elif fault == "d_dec_shape":
        d_dec = d_dec[:, :, :4].contiguous()
    elif fault == "d_dec_dtype":
        d_dec = d_dec.double()
    elif fault == "mom_shape":
        mom = mom[:, :1].contiguous()
    elif fault == "rows_device":
        rows = rows.cpu()
    elif fault == "rows_shape":
        rows = rows[:1]
    else:
        mode = "median"
    before = sk.decode_chain.launches
    with pytest.raises(ValueError):
        sk.decode_chain(hist, rows, mode, d_dec, mom)
    if fault in ("float16", "strided"):
        # the materialized route refuses such histograms at its forward
        with pytest.raises(ValueError):
            sk.decode_with_rows(hist.requires_grad_(), rows, mode)
    assert sk.decode_chain.launches == before


@pytest.mark.parametrize("stat,route", [
    ("mean", "inkernel"), ("mean", "materialized"), ("var", "inkernel"),
    ("var", "materialized"), ("entropy", "inkernel")])
def test_decode_chain_launches_once_a_backward(dev, stat, route):
    """``decode_chain.launches`` rises by one a direct call and by one a
    backward to the histograms, on either route."""
    hist, rows, mode, d_dec, mom = _chain_inputs(dev, torch.bfloat16,
                                                 (12, 8, 20, 24), stat
                                                 if stat != "mean" else
                                                 "linear", False)
    before = sk.decode_chain.launches
    sk.decode_chain(hist, rows, mode, d_dec, mom)
    assert sk.decode_chain.launches == before + 1
    h = hist.clone().requires_grad_()
    lut = torch.tensor(TF, device=dev, requires_grad=True)
    img = sv.pallas_hist_render_diff(
        h, rows, O, lut, 0.3, width=64, height=48, stat=mode,
        transfer_scale=10.0 if stat == "var" else 1.0, route=route,
        wrt=("hist", "lut"))
    torch.autograd.grad(img.square().mean(), [h, lut])
    torch.cuda.synchronize()
    assert sk.decode_chain.launches == before + 2


# ---- the flexible-block re-query (csrc/flex_blocks.cu) ----------------------

@pytest.mark.parametrize("bins", [2, 5, 64, 256])
@pytest.mark.parametrize("block", [1, 2, 3, 7])
def test_flex_blocks_matches_plain(dev, bins, block):
    """One launch gives every block's stats of an unaligned rough field
    within float32 rounding of the plain version (``IntegralVolume.blocks``
    off the card; each channel in units of
    its largest magnitude; the kernel sums the bins in another order and
    uses CUDA's log2f), the same bits on a second launch. (One bin has no
    entropy: both divide by log2 1 = 0.)"""
    from vrdd_tpu_torch.kernels import flex_blocks as fb
    from vrdd_tpu_torch.models.flexible import IntegralVolume
    from vrdd_tpu_torch.ops.integral import block_edges, integral_histogram

    g = torch.Generator(device=dev).manual_seed(10 * bins + block)
    field = torch.rand((11, 13, 17), generator=g, device=dev)
    sat = integral_histogram(field, bins, 0.0, 1.0)
    edges = [block_edges(n, block, dev) for n in field.shape]
    before = fb.block_stats.launches
    got = fb.block_stats(sat, edges)
    assert fb.block_stats.launches == before + 1
    want = IntegralVolume(sat.cpu()).blocks(block).stats_grid.to(dev)
    assert got.shape == want.shape
    scale = want.abs().reshape(-1, 3).amax(0).clamp(min=1e-30)
    assert float(((got - want).abs() / scale).max()) <= 2e-6
    assert torch.equal(got, fb.block_stats(sat, edges))


def test_flex_requery_waits_for_nothing(dev):
    """A re-query and its min-max map on the card make no host wait (torch's
    sync debug mode raises on one), and the grid is the fused kernel's."""
    from vrdd_tpu_torch.kernels import flex_blocks as fb
    from vrdd_tpu_torch.models.flexible import IntegralVolume

    field = torch.rand((21, 33, 39), device=dev)
    integral = IntegralVolume.from_raw(field, 64, 0.0, 1.0)
    torch.cuda.synchronize()
    before = fb.block_stats.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        vol = integral.blocks(4).normalized()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fb.block_stats.launches == before + 1
    assert vol.n_blocks == (6, 9, 10)
    r = vol.stat_ranges()
    np.testing.assert_allclose(r[:2], [[0.0, 1.0], [0.0, 1.0]], atol=1e-6)
