"""The staged fetch's footprint rule on the CPU, by brute force.

The staged sweep kernels (csrc/stage_tile.cuh) copy into shared memory, per
block and plane, the tap rectangle of the block's corner rays, in a tile
sized by the host bound ``slice_kernel.stage_bound``. Here every tap of every
ray of every block on every plane is computed with the kernels' tap
arithmetic in numpy float32 (each operation correctly rounded, as the CUDA
intrinsics), and the test checks that

- a block samples a plane only where the corner-ray test stages it;
- the corner-ray rectangle holds every tap its rays read there;
- the host bound holds every staged rectangle;
- the rectangle is tight: shrunk by one texel on any side, it misses a tap
  (the mutation a wrong corner choice would make);
- the plain sweep's nonzero resample columns lie in the rectangle.

The kernels themselves, staged against direct, run on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.march import shearwarp as sw
from vrdd_tpu_torch.march.slice import _axis_weights
from vrdd_tpu_torch.utils.config import MarchConfig

f32 = np.float32


def _plane_zs(n_planes, dz_sign):
    """The sweeps' plane depths over the box's z extent, front to back."""
    zs = (f32(-1.0) + f32(2.0 / n_planes)
          * (np.arange(n_planes, dtype=f32) + f32(0.5))).astype(f32)
    return zs[::-1].copy() if dz_sign < 0 else zs


def _params(origin, slopes, *, width, height, n, n_planes, dz_sign=-1,
            tex_offset=0.5, axis_scale=(1.0, 1.0), filter_linear=True):
    return sk._sweep_params(
        origin, slopes, 0.05, 1.0, 0.0, 1.0, 2.0 / n_planes, MarchConfig(),
        width=width, height=height, ny=n[0], nx=n[1], n_planes=n_planes,
        n_layers=n_planes, dz_sign=dz_sign, reverse=False,
        length_correction=True, tex_offset=tex_offset, axis_scale=axis_scale,
        filter_linear=filter_linear)


def _headline():
    """512^3 -> 1024^2 at a quarter: 128 planes of 128^2 -> 256^2."""
    return _params((0.0, 0.0, 4.0), sk.pixel_slope_params(256, 256),
                   width=256, height=256, n=(128, 128), n_planes=128), \
        _plane_zs(128, -1)


def _fit_voxels():
    """fit-voxels 256^3 -> 512^2 at a quarter: 64^3 in 128 planes -> 128^2."""
    return _params((0.0, 0.0, 4.0), sk.pixel_slope_params(128, 128),
                   width=128, height=128, n=(64, 64), n_planes=128), \
        _plane_zs(128, -1)


def _shearwarp(view):
    """A rotated view's m-grid (shear-warp's 'pallas' backend) over a
    permuted 40 x 48 x 56 volume, 2 planes per layer."""
    iv = inv_view_from_rotation_translation(*view, (0.0, 0.0, -4.0))
    _, (px, py, pz), dz_sign, ok, b = sw.slope_corner_bounds(iv, 96, 96)
    assert ok
    wi = -(-2 * 96 // 128) * 128
    mgrid = (*sw.mgrid_params(b[0], b[1], wi), *sw.mgrid_params(b[2], b[3],
                                                                 wi))
    shape = (40, 48, 56)  # (z, y, x) before the permutation
    n = (shape[2 - py], shape[2 - px])
    origin = tuple(float(iv[i, 3]) for i in (px, py, pz))
    n_planes = 2 * shape[2 - pz]
    return _params(origin, mgrid, width=wi, height=wi, n=n,
                   n_planes=n_planes, dz_sign=dz_sign), \
        _plane_zs(n_planes, dz_sign)


GEOMETRIES = {
    "headline": _headline,
    "fit_voxels": _fit_voxels,
    "shearwarp_x": lambda: _shearwarp((0.0, 60.0)),
    "shearwarp_y_dz_plus": lambda: _shearwarp((180.0, 30.0)),
    # query 7's block-boundary grid (tex_offset 0) with the flexible
    # blocks' axis_scale
    "tex_offset_0_axis_scale": lambda: (_params(
        (0.0, 0.0, 4.0), sk.pixel_slope_params(100, 72), width=100,
        height=72, n=(24, 26), n_planes=48, tex_offset=0.0,
        axis_scale=(12 / 13, 10 / 11)), _plane_zs(48, -1)),
    "nearest": lambda: (_params(
        (0.0, 0.0, 4.0), sk.pixel_slope_params(136, 96), width=136,
        height=96, n=(20, 24), n_planes=40, filter_linear=False),
        _plane_zs(40, -1)),
    "dz_plus": lambda: (_params(
        (0.2, -0.1, -4.0), sk.pixel_slope_params(100, 72, focal=-2.0),
        width=100, height=72, n=(24, 24), n_planes=48, dz_sign=1),
        _plane_zs(48, 1)),
    "camera_inside": lambda: (_params(
        (0.1, -0.2, 0.3), sk.pixel_slope_params(128, 96), width=128,
        height=96, n=(32, 32), n_planes=64), _plane_zs(64, -1)),
}


def _axis_taps(coord, n, lo, hi, scale, tex_offset, linear):
    """``axis_taps`` of csrc/sweep_common.cuh: (position in the box, first
    tap, second tap) per coordinate."""
    p01 = (coord - f32(lo)) / (f32(hi) - f32(lo))
    q = p01 * (f32(n) * f32(scale)) - f32(tex_offset)
    q = np.minimum(np.maximum(q, f32(0.0)), f32(n - 1))
    if not linear:
        q = np.floor(q + f32(0.5))
    i0 = np.floor(q).astype(np.int64)
    return p01, i0, np.minimum(i0 + 1, n - 1)


def _axis(p, zs, o, m, n, lo, hi, scale, block):
    """Per plane (rows) and block (columns) on one axis: the corner rays'
    rectangle (lo, hi) and their out-of-box test, and the taps the block's
    in-box rays read (min, max; -1 where none)."""
    coord = f32(o) + (zs[:, None] - f32(p["oz"])) * m[None, :]
    p01, i0, i1 = _axis_taps(coord, n, lo, hi, scale, p["tex_offset"],
                             p["filter_linear"])
    inb = (p01 >= 0.0) & (p01 <= 1.0)
    starts = np.arange(0, m.shape[0], block)
    ends = np.minimum(starts + block, m.shape[0]) - 1
    rect_lo = np.minimum(i0[:, starts], i0[:, ends])
    rect_hi = np.maximum(i1[:, starts], i1[:, ends])
    out = (((p01[:, starts] < 0) & (p01[:, ends] < 0))
           | ((p01[:, starts] > 1) & (p01[:, ends] > 1)))
    big = np.iinfo(np.int64).max
    tap_lo = np.minimum.reduceat(np.where(inb, i0, big), starts, axis=1)
    tap_hi = np.maximum.reduceat(np.where(inb, i1, -1), starts, axis=1)
    any_in = np.add.reduceat(inb.astype(np.int64), starts, axis=1) > 0
    return dict(rect_lo=rect_lo, rect_hi=rect_hi, out=out, tap_lo=tap_lo,
                tap_hi=tap_hi, any_in=any_in, coord=coord, inb=inb,
                starts=starts, ends=ends)


@pytest.mark.parametrize("block", [sk.ESS_TILE[::-1], sk.BWD_BLOCK])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_footprint_holds_every_tap(name, block):
    p, zs = GEOMETRIES[name]()
    cols, rows = block
    mx, my = sk._slope_grids((p["mx0"], p["dmx"], p["my0"], p["dmy"]),
                             p["width"], p["height"])
    ax = _axis(p, zs, p["ox"], mx, p["nx"], p["xlo"], p["xhi"], p["sx"],
               cols)
    ay = _axis(p, zs, p["oy"], my, p["ny"], p["ylo"], p["yhi"], p["sy"],
               rows)
    front = (zs < p["oz"]) if p["dz_sign"] < 0 else (zs > p["oz"])
    tw, th = sk.stage_bound(p, zs, block)

    # staged per (plane, block row, block column), and sampled
    staged = (front[:, None, None] & ~ax["out"][:, None, :]
              & ~ay["out"][:, :, None])
    sampled = (front[:, None, None] & ax["any_in"][:, None, :]
               & ay["any_in"][:, :, None])
    assert sampled.any(), "vacuous: no block samples any plane"
    assert not (sampled & ~staged).any(), "a sampled plane is not staged"

    for a, bound in ((ax, tw), (ay, th)):
        # per (plane, block on this axis): sampled if some block across
        # samples with it
        live = front[:, None] & a["any_in"] & (
            (ay if a is ax else ax)["any_in"].any(axis=1)[:, None])
        assert (a["rect_lo"][live] <= a["tap_lo"][live]).all()
        assert (a["rect_hi"][live] >= a["tap_hi"][live]).all()
        st = front[:, None] & ~a["out"]
        width = a["rect_hi"] - a["rect_lo"] + 1
        assert (width[st] <= bound).all(), (int(width[st].max()), bound)
        # the mutation: a rectangle shrunk by one texel on either side
        # misses a tap the block reads
        assert (a["tap_lo"][live] < a["rect_lo"][live] + 1).any()
        assert (a["tap_hi"][live] > a["rect_hi"][live] - 1).any()

    # the plain sweep's nonzero resample columns of in-box rays lie in the
    # rectangle (a few planes: the weights are dense matrices)
    for k in np.linspace(0, len(zs) - 1, 5).astype(int):
        if not front[k]:
            continue
        for a, n, lo, hi, sc in ((ax, p["nx"], p["xlo"], p["xhi"], p["sx"]),
                                 (ay, p["ny"], p["ylo"], p["yhi"], p["sy"])):
            w = _axis_weights(torch.from_numpy(a["coord"][k]), n, lo, hi,
                              p["tex_offset"], sc, bool(p["filter_linear"]))
            for b, (s, e) in enumerate(zip(a["starts"], a["ends"])):
                cols_nz = torch.nonzero(w[s:e + 1].abs().sum(0)).flatten()
                if len(cols_nz):
                    assert a["rect_lo"][k, b] <= int(cols_nz.min())
                    assert a["rect_hi"][k, b] >= int(cols_nz.max())


def test_budget_sends_a_coarse_image_direct():
    """The headline's footprint fits the staged budget on both kernels; an
    image much coarser than the volume does not (it takes the direct
    path), and its tile is capped at the volume's size."""
    p, zs = _headline()
    for block, ck in ((sk.ESS_TILE[::-1], 0), (sk.BWD_BLOCK, 8)):
        tw, th = sk.stage_bound(p, zs, block)
        assert sk.stage_smem_bytes(
            tw, th, n_bins=16, elem_size=2, n_lut=9, row_floats=64,
            bwd_ck=ck, g_planes=ck > 0, momt=ck > 0,
            g_small=ck > 0) <= sk._STAGE_BUDGET
        assert sk._stage_dims(None, (tw, th), 1) == (tw, th)
    coarse = _params((0.0, 0.0, 4.0), sk.pixel_slope_params(16, 16),
                     width=16, height=16, n=(512, 512), n_planes=8)
    tw, th = sk.stage_bound(coarse, _plane_zs(8, -1), (32, 8))
    assert tw == 512 and th == 512
    smem = sk.stage_smem_bytes(tw, th, n_bins=1, elem_size=4, n_lut=9,
                               row_floats=0)
    assert sk._stage_dims(None, (tw, th), smem) == (0, 0)
    assert sk._stage_dims(False, (tw, th), 1) == (0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        sk._stage_dims(True, (tw, th), smem)
    assert sk._stage_dims(None, (41, 11), 1, prefer=False) == (0, 0)
    with sk._fetch_path(True):
        assert sk._stage_dims(None, (41, 11), 1, prefer=False) == (41, 11)
        assert sk._stage_dims(None, (41, 11), sk._STAGE_BUDGET + 1) == (41,
                                                                        11)
    with sk._fetch_path(False):
        assert sk._stage_dims(None, (41, 11), 1) == (0, 0)
