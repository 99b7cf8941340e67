"""Empty-space skipping (ESS) of the port on the CPU: the plane statistics
against the JAX package's, the bitmap's conservativeness by brute force
against the plain sweep's per-sample alpha, and the ESS renders against the
renders without ESS (port) and with ESS (JAX, in interpret mode).

The CUDA kernel's ESS (bitwise the image without ESS) is tested on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.pallas import slice_kernel as jk
from vrdd_tpu.pallas import slice_vjp as jv
from vrdd_tpu.utils.config import MarchConfig as JMarch
from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.kernels import slice_vjp as sv
from vrdd_tpu_torch.march.slice import _chunk_rgba_fn, preblend_planes
from vrdd_tpu_torch.utils.config import MarchConfig

TF = default_transfer_function()
O = (0.0, 0.0, 4.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band_lut():
    """Zero alpha below ~0.5, a ramp above (tests/test_pallas_slice.py:91-95)."""
    lut = np.zeros((8, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 8)
    lut[5:, 3] = [0.3, 0.7, 1.0]
    return lut


def _long_band_lut():
    """40 entries (more than one group of knots the bitmap tests at once):
    zero alpha on [0, 0.5), then a ramp with a zero-alpha gap."""
    lut = np.zeros((40, 4), dtype=np.float32)
    lut[:, 1] = np.linspace(0, 1, 40)
    lut[20:, 3] = np.linspace(0.2, 1.0, 20)
    lut[30:33, 3] = 0.0
    return lut


def _sparse_volume(shape=(16, 24, 24), seed=5):
    """Mostly empty: one block of values in [0.7, 1] in a zero volume."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    nz, ny, nx = shape
    vol[nz // 4:nz // 2, ny // 4:ny // 2, nx // 4:nx // 2] = rng.uniform(
        0.7, 1.0, (nz // 2 - nz // 4, ny // 2 - ny // 4, nx // 2 - nx // 4))
    return vol


@pytest.mark.parametrize("dz_sign,tex_offset", [(-1, 0.5), (1, 0.5),
                                                (-1, 0.0)])
def test_plane_stats_match_jax(dz_sign, tex_offset):
    """Unaligned to the 8 x 8 block grid (13 x 18 planes)."""
    vol = np.random.default_rng(0).random((10, 13, 18)).astype(np.float32)
    march = MarchConfig(box_min=(-1.0, -0.8, -1.0), box_max=(1.0, 1.0, 0.9))
    jm = JMarch(box_min=march.box_min, box_max=march.box_max)
    ref = jk.precompute_ess_stats(jnp.asarray(vol), n_planes=24, march=jm,
                                  dz_sign=dz_sign, tex_offset=tex_offset)
    got = sk.precompute_ess_stats(torch.from_numpy(vol), n_planes=24,
                                  march=march, dz_sign=dz_sign,
                                  tex_offset=tex_offset)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (24, 8, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    planes = np.random.default_rng(1).random((5, 9, 17)).astype(np.float32)
    for g, r in zip(sk.ess_plane_stats(torch.from_numpy(planes)),
                    jk.ess_plane_stats(jnp.asarray(planes))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


CONSERVATIVE = {
    # name: (lut, transfer_offset, transfer_scale, width, height,
    #        tex_offset, axis_scale)
    "rainbow": (TF, 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0)),
    "band": (_band_lut(), 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0)),
    "negative_scale": (TF, 1.0, -1.0, 64, 48, 0.5, (1.0, 1.0, 1.0)),
    "axis_scale": (_band_lut(), 0.0, 1.0, 64, 48, 0.5,
                   (12 / 13, 12 / 13, 10 / 11)),
    "tex_offset_0": (TF, 0.0, 1.0, 64, 48, 0.0, (1.0, 1.0, 1.0)),
    "unaligned": (_band_lut(), 0.0, 1.0, 100, 37, 0.5, (1.0, 1.0, 1.0)),
    "long_lut": (_long_band_lut(), 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0)),
}


@pytest.mark.parametrize("case", sorted(CONSERVATIVE))
def test_bitmap_is_conservative(case):
    """Brute force: every sample of every culled (tile, chunk) has alpha
    exactly 0 in the plain sweep, at every ray and plane."""
    lut, toff, tscl, W, H, tex_offset, axis_scale = CONSERVATIVE[case]
    vol = torch.from_numpy(_sparse_volume())
    march = MarchConfig()
    n_planes, chunk = 32, 8
    planes, zs = preblend_planes(vol, n_planes, march.box_min, march.box_max,
                                 -1, tex_offset, z_scale=axis_scale[2])
    mx, my = sk._pixel_slopes(W, H, 2.0)
    slopes = (*sk._uniform_grid_params(mx, "mx"),
              *sk._uniform_grid_params(my, "my"))
    bitmap = sk.ess_bitmap(
        sk.ess_plane_stats(planes), zs, O, slopes, lut, toff, tscl, width=W,
        height=H, ny=24, nx=24, plane_chunk=chunk, march=march,
        tex_offset=tex_offset, axis_scale=axis_scale[:2])
    assert tuple(bitmap.shape) == (n_planes // chunk, -(-H // 8), -(-W // 32))
    mxg, myg = sk._slope_grids(slopes, W, H)
    rgba = _chunk_rgba_fn(n_planes, 24, 24, zs, torch.tensor(O), mxg, myg,
                          march, -1, None, True, tex_offset, axis_scale[:2],
                          True, torch.device("cpu"))
    alpha = rgba(0, planes, torch.from_numpy(lut), 0.8, toff, tscl)[..., 3]
    th, tw = sk.ESS_TILE
    live = bitmap[torch.arange(n_planes) // chunk][
        :, torch.arange(H) // th][:, :, torch.arange(W) // tw] != 0
    assert not live.all() and live.any(), "vacuous: nothing (or all) culled"
    assert (alpha[~live] == 0).all(), float(alpha[~live].abs().max())


@pytest.mark.parametrize("lut_name", ["rainbow", "band"])
@pytest.mark.parametrize("n_planes", [16, 32])
def test_ess_render_equals_plain_and_jax(lut_name, n_planes):
    """pallas_slice_render(empty_space_skip=True) on the CPU is bitwise the
    render without ESS, and JAX's ESS render (interpret mode) within 1e-4 on
    all but 0.1% of pixels. n_planes == nz is the pure-selection schedule
    (with cached stats) or the pre-blend (without)."""
    lut = TF if lut_name == "rainbow" else _band_lut()
    vol = _sparse_volume()
    vt = torch.from_numpy(vol)
    kw = dict(width=72, height=40, n_planes=n_planes)
    plain = sk.pallas_slice_render(vt, O, lut, 0.8, **kw)
    ess = sk.pallas_slice_render(vt, O, lut, 0.8, empty_space_skip=True, **kw)
    stats = sk.precompute_ess_stats(vt, n_planes=n_planes)
    cached = sk.pallas_slice_render(vt, O, lut, 0.8, empty_space_skip=True,
                                    ess_stats=stats, **kw)
    assert torch.equal(ess, plain) and torch.equal(cached, plain)
    assert float(plain[..., 3].max()) > 0.05, "vacuous: empty render"
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.pallas_slice_render(
            jnp.asarray(vol), jnp.asarray(O), jnp.asarray(lut), 0.8,
            empty_space_skip=True, **kw))
    bad = (np.abs(ess.numpy() - ref) > 1e-4).any(-1)
    assert bad.mean() <= 1e-3, bad.mean()


def test_ess_stats_shape_is_checked():
    vt = torch.from_numpy(_sparse_volume())
    stats = sk.precompute_ess_stats(vt, n_planes=16)
    with pytest.raises(ValueError, match="ess_stats"):
        sk.pallas_slice_render(vt, O, TF, width=8, height=8, n_planes=32,
                               empty_space_skip=True, ess_stats=stats)


def test_diff_ess_raises_for_other_wrt_as_jax():
    vol = _sparse_volume((8, 8, 8))
    with pytest.raises(ValueError, match="wrt"):
        jv.pallas_slice_render_diff(jnp.asarray(vol), jnp.asarray(O),
                                    jnp.asarray(TF), width=8, height=8,
                                    empty_space_skip=True)
    vt = torch.from_numpy(vol).requires_grad_()
    for wrt in (("volume", "lut", "params"), ("lut",), ("volume", "params")):
        with pytest.raises(ValueError, match="wrt"):
            sv.pallas_slice_render_diff(vt, O, TF, width=8, height=8,
                                        wrt=wrt, empty_space_skip=True)


@pytest.mark.parametrize("plane_chunk", [4, 8])
def test_diff_ess_volume_gradient_equals_without(plane_chunk):
    """wrt=('volume',): the image and d_volume with ESS are those without
    (plain versions: K4's image and checkpoints cull, K5 replays), and the
    checkpoints of the plain K4 with the bitmap are those without."""
    vol = _sparse_volume()
    kw = dict(width=40, height=24, wrt=("volume",), plane_chunk=plane_chunk)
    out = {}
    for ess in (False, True):
        v = torch.from_numpy(vol).requires_grad_()
        img = sv.pallas_slice_render_diff(v, O, _band_lut(), 0.8,
                                          empty_space_skip=ess, **kw)
        (g,) = torch.autograd.grad((img * img).sum(), [v])
        out[ess] = (img.detach(), g)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert float(out[True][1].abs().max()) > 0.0, "vacuous: zero gradient"
