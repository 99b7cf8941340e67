"""The staged fetch's footprint rule on the CPU, by brute force.

The staged sweep kernels (csrc/stage_tile.cuh) copy into shared memory, per
block and plane, the tap rectangle of the block's corner rays, in a tile
sized by the host bound ``launch.stage_bound``. Here every tap of every
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
from vrdd_tpu_torch.kernels import launch
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


@pytest.mark.parametrize("block", [launch.ESS_TILE[::-1], launch.BWD_BLOCK])
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
    tw, th = launch.stage_bound(p, zs, block)

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
    """The fetch-path rule: the headline's footprint fits the staged budget
    on both kernels, so both stage; an image much coarser than the volume
    does not (it takes the direct path, and forcing the staged path raises),
    and its tile is capped at the volume's size; a tile between the budget
    and a block's shared memory goes direct by default and stages when
    forced; K5 on scalar planes goes direct unless a path is forced."""
    p, zs = _headline()
    hist = dict(p, n_bins=16, n_rows=4)
    for kind, block, ck in (("fwd", launch.ESS_TILE[::-1], 0),
                            ("bwd", launch.BWD_BLOCK, 8)):
        tw, th = launch.stage_bound(p, zs, block)
        assert launch.stage_smem_bytes(
            tw, th, n_bins=16, elem_size=2, n_lut=9, row_floats=64,
            bwd_ck=ck, g_planes=ck > 0, momt=ck > 0,
            g_small=ck > 0) <= launch._STAGE_BUDGET
        assert launch.stage_dims(
            kind, "var", hist, zs, elem_size=2, n_lut=9, row_floats=64,
            ck_stride=ck, g_planes=ck > 0, g_small=ck > 0) == (tw, th)
    coarse = _params((0.0, 0.0, 4.0), sk.pixel_slope_params(16, 16),
                     width=16, height=16, n=(512, 512), n_planes=8)
    czs = _plane_zs(8, -1)
    tw, th = launch.stage_bound(coarse, czs, (32, 8))
    assert tw == 512 and th == 512
    assert launch.stage_smem_bytes(tw, th, n_bins=1, elem_size=4, n_lut=9,
                                   row_floats=0) > launch._SMEM_MAX

    def fwd(geometry, depths, **kw):
        return launch.stage_dims("fwd", "none", geometry, depths,
                                 elem_size=4, n_lut=9, **kw)

    assert fwd(coarse, czs) == (0, 0)
    assert fwd(coarse, czs, staged=False) == (0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        fwd(coarse, czs, staged=True)
    # a long LUT's ESS table overflows a block on the direct path too
    ess = launch._ess_smem_bytes(3072, 40000)
    with pytest.raises(ValueError, match="shared memory"):
        launch.stage_dims("fwd", "none", coarse, czs, elem_size=4,
                          n_lut=3072, ess_bytes=ess)
    mid = _params((0.0, 0.0, 4.0), sk.pixel_slope_params(32, 32), width=32,
                  height=32, n=(128, 128), n_planes=8)
    bound = launch.stage_bound(mid, czs, (32, 8))
    smem = launch.stage_smem_bytes(*bound, n_bins=1, elem_size=4, n_lut=9,
                                   row_floats=0, slots=3)
    assert launch._STAGE_BUDGET < smem <= launch._SMEM_MAX
    assert fwd(mid, czs) == (0, 0)
    k5 = dict(elem_size=4, n_lut=9, ck_stride=8, g_planes=True)
    assert launch.stage_dims("bwd", "none", p, zs, **k5) == (0, 0)
    with sk._fetch_path(True):
        assert launch.stage_dims("bwd", "none", p, zs, **k5) == \
            launch.stage_bound(p, zs, launch.BWD_BLOCK)
        assert fwd(mid, czs) == bound
    with sk._fetch_path(False):
        assert fwd(*_headline()) == (0, 0)


# ---- the staged launch's shared memory -------------------------------------

def _stage_layout(tw_b, th_b, B, es, n_lut, row_floats, nslot, extra):
    """``stage_layout`` of csrc/stage_tile.cuh, line for line: the byte
    offsets of a staged launch's dynamic shared memory and its total."""
    rc = (tw_b * es + 30) // 16
    ring = th_b * B * rc * 16
    off_lut = nslot * ring
    off_rows = off_lut + 4 * 4 * n_lut
    off_dec = off_rows + 4 * row_floats
    off_rowoff = off_dec + 4 * tw_b * th_b
    off_extra = off_rowoff + nslot * 4 * th_b * B
    return dict(ring=ring, off_lut=off_lut, off_extra=off_extra,
                total=off_extra + extra)


def _bwd_extra(tile, n_lut, ck, gvol, momt, gsmall, threads=128):
    """``bwd_extra`` of csrc/slice_vjp_staged.cu."""
    return 4 * (3 * ck * threads + (2 * tile if gvol else 0)
                + (3 * tile if momt else 0)
                + ((4 * n_lut + 3) * threads if gsmall else 0))


@pytest.mark.parametrize("foot", [(41, 11), (41, 6), (7, 3), (130, 33)])
@pytest.mark.parametrize("kernel", ["fwd", "fwd_ess", "bwd", "bwd_var"])
@pytest.mark.parametrize("planes", ["f32", "bf16_b16", "bf16_b32"])
def test_stage_smem_bytes_mirrors_stage_layout(planes, kernel, foot):
    """The wrapper's shared-memory count is the kernels' layout at odd
    footprints, for the rings they take: three slots for the forward on
    scalar planes, two otherwise."""
    es, B = {"f32": (4, 1), "bf16_b16": (2, 16), "bf16_b32": (2, 32)}[planes]
    rows = 0 if B == 1 else 4 * B
    tw, th = foot
    ck = 8 if kernel.startswith("bwd") else 0
    momt = kernel == "bwd_var"
    ess = 4 * 9 * 4 + 16 if kernel == "fwd_ess" else 0
    extra = _bwd_extra(tw * th, 9, ck, True, momt, True) if ck else ess
    slots = 3 if B == 1 and not ck else 2
    want = _stage_layout(tw, th, B, es, 9, rows, slots, extra)["total"]
    assert launch.stage_smem_bytes(
        tw, th, n_bins=B, elem_size=es, n_lut=9, row_floats=rows,
        slots=slots, bwd_ck=ck, g_planes=bool(ck), momt=momt,
        g_small=bool(ck), ess_bytes=ess) == want


def _fit_smem(stat, kernel, staged=None):
    """The dynamic shared memory of the fit cells' K4 or K5 launch (512^3 x
    16 bf16 bins-major histograms -> 1024^2, ``wrt=("hist", "lut")``), or
    of K4 and K5 on the decoded f32 planes (``stat`` 'scalar'), as the
    wrappers count it, the footprint bound, and the fetch path the rule
    gives it (``staged`` forces one)."""
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    mode = {"mean": "linear", "var": "var", "entropy": "entropy",
            "scalar": "none"}[stat]
    shape = (512, 512, 512) if mode == "none" else (512, 16, 512, 512)
    rows = None
    if mode != "none":
        rows, _ = sk.decode_weight_rows(stat, 16, family="unit")
    cfg = sv.render_config(shape, (0.0, 0.0, 4.0), stat=mode, width=1024,
                           height=1024)
    params = cfg.params(torch.empty(shape, device="meta"), rows, 0.05, 0.0,
                        1.0)
    bwd = kernel == "K5"
    block = launch.BWD_BLOCK if bwd else launch.ESS_TILE[::-1]
    bound = launch.stage_bound(params, cfg.zs, block)
    B, es = (1, 4) if mode == "none" else (16, 2)
    row_floats = 0 if rows is None else rows.size
    smem = launch.stage_smem_bytes(
        *bound, n_bins=B, elem_size=es, n_lut=9, row_floats=row_floats,
        slots=3 if mode == "none" and not bwd else 2,
        bwd_ck=cfg.ck_stride if bwd else 0, g_planes=bwd,
        momt=bwd and mode == "var", g_small=bwd)
    dims = launch.stage_dims(
        "bwd" if bwd else "fwd", mode, params, cfg.zs, elem_size=es,
        n_lut=9, row_floats=row_floats, staged=staged,
        ck_stride=cfg.ck_stride if bwd else 0, g_planes=bwd, g_small=bwd)
    return smem, bound, dims


@pytest.mark.parametrize("kernel,stat,staged,path", [
    pytest.param(k, s, True if (k, s) == ("K5", "scalar") else None,
                 "staged", id=f"{k}-{s}")
    for k in ("K4", "K5") for s in ("mean", "var", "entropy", "scalar")
] + [pytest.param("K5", "scalar", None, "direct", id="K5-scalar-default")])
def test_fit_launches_stay_staged(kernel, stat, staged, path):
    """Every K4 and K5 launch of the fit cells' geometry, and K4 on scalar
    f32 planes, fits :data:`_STAGE_BUDGET` with the ring the kernels take,
    so the fetch-path rule drops none of them to the direct path; K5 on the
    decoded f32 planes fits when its staged path is forced, and by default
    goes direct."""
    smem, bound, dims = _fit_smem(stat, kernel, staged)
    assert smem <= launch._STAGE_BUDGET
    assert dims == (bound if path == "staged" else (0, 0))


@pytest.mark.parametrize("predicate", ["pallas_supported",
                                       "hist_render_supported",
                                       "pallas_diff_supported"])
def test_support_predicates_accept_the_luts_they_always_took(predicate):
    """What each support predicate answers over LUTs of 1-48 entries and
    1-64 bins, and at the edge of the forward's shared memory: the largest
    LUT each accepts, so the configurations that raised still raise. The
    differentiable sweep's own check (``_Sweep.check``, which K3 runs too)
    holds K5's LUT columns beside the decode rows: 23 entries up to 9 bins,
    22 beyond."""
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    def accepts(n_lut, bins):
        if predicate == "pallas_supported":
            return sk.pallas_supported((4, 5, 6), 8, 8, 4, n_lut)
        if predicate == "hist_render_supported":
            return sk.hist_render_supported((4, bins, 5, 6), 8, 8, n_lut)
        return sv.pallas_diff_supported((4, 5, 6), 8, 8, 4, n_lut)

    want = 23 if predicate == "pallas_diff_supported" else 48
    for bins in range(1, 65):
        took = [n for n in range(0, 49) if accepts(n, bins)]
        assert took == list(range(1, want + 1)), bins
    if predicate == "pallas_supported":
        assert accepts(3072, 1) and not accepts(3073, 1)
    elif predicate == "hist_render_supported":
        for bins in (1, 16, 64):
            assert accepts(3072 - bins, bins)
            assert not accepts(3073 - bins, bins)
    else:
        for mode, bins in [("none", 1)] + [(m, b) for m in ("linear", "var")
                                           for b in (1, 9, 10, 64)]:
            shape = (4, 5, 6) if mode == "none" else (4, bins, 5, 6)
            cfg = sv.render_config(shape, (0.0, 0.0, 4.0), stat=mode,
                                   width=8, height=8)
            vol = torch.empty(shape, device="meta")
            largest = 23 if bins <= 9 else 22
            for n_lut in (0, largest + 1):
                with pytest.raises(ValueError, match="cannot take"):
                    cfg.check(vol, torch.empty((n_lut, 4)))
            cfg.check(vol, torch.empty((largest, 4)))


@pytest.mark.parametrize("stat", ["scalar", "var"])
@pytest.mark.parametrize("scalars", [(0.05, 0.1, 1.0 / 3.0),
                                     (1.0 / 3.0, -0.05, 12.1)])
def test_host_scalars_keep_the_kernels_sweep_params(scalars, stat):
    """``_Sweep.params`` from density, TF offset and TF scale given as
    Python floats, numpy float64 scalars or float64 CPU tensors
    (``launch.host_scalars``) equals, field for field and byte for byte in
    the kernels' ``SweepParams``, its parameters from 0-d float32 tensors:
    each number rounded to float32 once, the value the old upload to the
    card and read back gave. None of the numbers is a float32."""
    from vrdd_tpu_torch.kernels import _build
    from vrdd_tpu_torch.kernels import slice_vjp as sv

    assert all(float(np.float32(v)) != v for v in scalars)
    mode = "none" if stat == "scalar" else stat
    shape = (6, 10, 12) if mode == "none" else (6, 4, 10, 12)
    rows = None if mode == "none" else sk.decode_weight_rows(
        stat, 4, family="unit")[0]
    cfg = sv.render_config(shape, (0.0, 0.0, 4.0), stat=mode, width=24,
                           height=16)
    vol = torch.empty(shape, device="meta")
    # the parent's reading: float() of each float32 tensor
    f32 = [torch.tensor(v, dtype=torch.float32) for v in scalars]
    want = cfg.params(vol, rows, *(float(t) for t in f32))
    forms = [scalars, [np.float64(v) for v in scalars],
             [torch.tensor(v, dtype=torch.float64) for v in scalars], f32]
    for form in forms:
        got = launch.host_scalars(*form)
        assert all(type(v) is float for v in got)
        params = cfg.params(vol, rows, *got)
        assert params == want
        assert bytes(_build.SweepParams(n_lut=9, **params)) == bytes(
            _build.SweepParams(n_lut=9, **want))
    assert (want["density"], want["tf_off"], want["tf_scale"]) == tuple(
        float(t) for t in f32)
