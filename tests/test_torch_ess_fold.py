"""The ESS interval test as the sweep kernels run it (csrc/ess_common.cuh),
written out in plain numpy in the kernels' order, held byte for byte
against ``slice_kernel.ess_bitmap_reference`` and checked for
conservativeness by brute force against the plain sweep's per-sample alpha.

The order (``ess_chunk_live``; the sweep kernels run it at block start, a
chunk a group of lanes (``ess_tile_bits``), and the standalone bitmap
kernel a (tile, chunk) a thread): the chunk's depth range, the tile's block
range over it, the min / max of each plane's blocks, then the LUT's largest
|alpha| over the value interval: its two ends, and the knots inside by one
query of the sparse table (level j holds the max of 2^j consecutive
knots). In a group of G lanes each lane folds every G-th plane of the
chunk, and the lanes combine depths and statistics by an xor butterfly.

The kernels' bits themselves are held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 7); JAX's ``_ess_bitmap``
packs other words over other tiles, so the JAX side is held through the
plane statistics and the ESS images (tests/test_torch_ess.py)."""

import math

import numpy as np
import pytest
import torch

from vrdd_tpu_torch.core.transfer import default_transfer_function
from vrdd_tpu_torch.kernels import launch
from vrdd_tpu_torch.kernels import slice_kernel as sk
from vrdd_tpu_torch.march.slice import _chunk_rgba_fn, preblend_planes
from vrdd_tpu_torch.utils.config import MarchConfig

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: the suite runs several test
    processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band_lut():
    """Zero alpha below ~0.5, a ramp above."""
    lut = np.zeros((8, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 8)
    lut[5:, 3] = [0.3, 0.7, 1.0]
    return lut


def _long_band_lut():
    """40 entries: zero alpha on [0, 0.5), then a ramp with a zero gap."""
    lut = np.zeros((40, 4), dtype=np.float32)
    lut[:, 1] = np.linspace(0, 1, 40)
    lut[20:, 3] = np.linspace(0.2, 1.0, 20)
    lut[30:33, 3] = 0.0
    return lut


def _lut256():
    """256 entries of random alpha with zero runs at both ends and one
    inside, as a fitted LUT may have."""
    rng = np.random.default_rng(11)
    lut = rng.uniform(0.0, 1.0, (256, 4)).astype(np.float32)
    lut[:100, 3] = 0.0
    lut[140:150, 3] = 0.0
    lut[200:, 3] = 0.0
    lut[160:170, 3] *= -1.0  # |alpha| is what the test bounds
    return lut


LUTS = {"rainbow": default_transfer_function(), "band": _band_lut(),
        "long_band": _long_band_lut(), "lut256": _lut256()}

CASES = {
    # name: (lut, transfer_offset, transfer_scale, width, height,
    #        tex_offset, axis_scale, n_planes, plane_chunk, camera seed)
    "rainbow_c8": ("rainbow", 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 32,
                   8, 0),
    "band_ragged_c5": ("band", 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 43,
                       5, 1),
    "negative_scale_c12": ("rainbow", 1.0, -1.0, 100, 37, 0.5,
                           (1.0, 1.0, 1.0), 48, 12, 2),
    "axis_scale_c8": ("band", 0.0, 1.0, 64, 48, 0.5,
                      (12 / 13, 12 / 13, 10 / 11), 32, 8, 3),
    "tex_offset_0_c4": ("rainbow", 0.0, 1.0, 64, 48, 0.0, (1.0, 1.0, 1.0),
                        45, 4, 4),
    "long_lut_c40": ("long_band", 0.0, 1.0, 136, 96, 0.5, (1.0, 1.0, 1.0),
                     90, 40, 5),
    "lut256_c8": ("lut256", 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 48, 8,
                  6),
    "lut256_tex0_ragged_c7": ("lut256", 0.2, 1.5, 100, 72, 0.0,
                              (1.0, 1.0, 1.0), 50, 7, 7),
    "lut256_negative_c3": ("lut256", 1.0, -1.0, 72, 40, 0.5,
                           (1.0, 1.0, 1.0), 33, 3, 8),
    "band_c1": ("band", 0.0, 1.0, 40, 24, 0.5, (1.0, 1.0, 1.0), 20, 1, 9),
    "rainbow_c33": ("rainbow", 0.0, 1.0, 64, 48, 0.5, (1.0, 1.0, 1.0), 70,
                    33, 10),
    "band_tex0_scale_c16": ("band", 0.0, 1.0, 96, 64, 0.0,
                            (0.9, 1.0, 1.0), 48, 16, 11),
    "lut256_wide_c8": ("lut256", 0.0, 1.0, 136, 96, 0.5, (1.0, 1.0, 1.0),
                       40, 8, 12),
}


def _sparse_volume(shape=(16, 24, 24), seed=5):
    """Mostly empty: one block of values in [0.7, 1] in a zero volume."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, dtype=np.float32)
    nz, ny, nx = shape
    vol[nz // 4:nz // 2, ny // 4:ny // 2, nx // 4:nx // 2] = rng.uniform(
        0.7, 1.0, (nz // 2 - nz // 4, ny // 2 - ny // 4, nx // 2 - nx // 4))
    return vol


def _setup(case):
    """The plane stack, its statistics, the camera and the test's
    geometry for one case."""
    lut_name, toff, tscl, W, H, tex_offset, axis_scale, P, chunk, seed = (
        CASES[case])
    rng = np.random.default_rng(seed)
    origin = (float(rng.uniform(-0.4, 0.4)), float(rng.uniform(-0.4, 0.4)),
              float(rng.uniform(3.0, 5.0)))
    mx, my = sk._pixel_slopes(W, H, float(rng.uniform(1.5, 3.0)))
    slopes = (*sk._uniform_grid_params(mx, "mx"),
              *sk._uniform_grid_params(my, "my"))
    march = MarchConfig()
    planes, zs = preblend_planes(torch.from_numpy(_sparse_volume()), P,
                                 march.box_min, march.box_max, -1,
                                 tex_offset, z_scale=axis_scale[2])
    stats = sk.ess_plane_stats(planes)
    lut = LUTS[lut_name]
    kw = dict(width=W, height=H, ny=24, nx=24, plane_chunk=chunk,
              march=march, tex_offset=tex_offset, axis_scale=axis_scale[:2])
    args = (zs, origin, slopes, lut, toff, tscl)
    ox, oy, oz = sk._host_floats(origin, 3)
    mx0, dmx, my0, dmy = sk._host_floats(slopes, 4)
    geo = dict(ox=ox, oy=oy, oz=oz, mx0=mx0, dmx=dmx, my0=my0, dmy=dmy,
               box=(march.box_min, march.box_max), tex_offset=tex_offset,
               sx=float(axis_scale[0]), sy=float(axis_scale[1]), W=W, H=H,
               P=P, chunk=chunk, ny=24, nx=24, toff=toff, tscl=tscl,
               q_margin=sk._ESS_Q_MARGIN)
    return planes, stats, args, kw, geo, lut


# ---- the kernels' test, written out ------------------------------------------

def _table(la):
    """The sparse table of |alpha| (ess_table_build): level j, i holds the
    max of knots i .. i + 2^j - 1."""
    n = len(la)
    t = [la.astype(F32)]
    for j in range(1, n.bit_length()):
        prev, half = t[-1], 1 << (j - 1)
        row = np.full(n, np.nan, F32)
        m = n - (1 << j) + 1
        row[:m] = np.maximum(prev[:m], prev[half:half + m])
        t.append(row)
    return t


def _range_max(t, lo, hi):
    """ess_range_max: two overlapping runs of one level."""
    j = (hi - lo + 1).bit_length() - 1
    return max(t[j][lo], t[j][hi - (1 << j) + 1])


def _tile_blocks(g, ty, tx, z_lo, z_hi):
    """ess_tile_blocks: float64, operation for operation."""
    th, tw = sk.ESS_TILE
    dz_lo, dz_hi = float(z_lo) - g["oz"], float(z_hi) - g["oz"]

    def corner(o, m0, dm, size, t, extent):
        first, last = float(t * size), float(min(t * size + size, extent) - 1)
        ma, mb = m0 + dm * first, m0 + dm * last
        c = (o + dz_lo * ma, o + dz_lo * mb, o + dz_hi * ma, o + dz_hi * mb)
        return min(c), max(c)

    def blocks(lo_w, hi_w, axis, N, scale):
        lo_box, hi_box = g["box"][0][axis], g["box"][1][axis]
        ext, ns, bsz = hi_box - lo_box, N * scale, float(-(-N // 8))
        v_lo = math.floor((lo_w - lo_box) / ext * ns - g["tex_offset"]) - 1.0
        v_hi = math.ceil((hi_w - lo_box) / ext * ns - g["tex_offset"]) + 2.0
        return tuple(int(min(max(math.floor(v / bsz), 0.0), 7.0))
                     for v in (v_lo, v_hi))

    y = corner(g["oy"], g["my0"], g["dmy"], th, ty, g["H"])
    x = corner(g["ox"], g["mx0"], g["dmx"], tw, tx, g["W"])
    return (*blocks(*y, 1, g["ny"], g["sy"]),
            *blocks(*x, 0, g["nx"], g["sx"]))


def _plane_range(pmin, pmax, k, b, vmin, vmax):
    """ess_plane_range: fold plane k's blocks into [vmin, vmax]."""
    by0, by1, bx0, bx1 = b
    for by in range(by0, by1 + 1):
        for bx in range(bx0, bx1 + 1):
            vmin, vmax = min(vmin, pmin[k, by, bx]), max(vmax, pmax[k, by, bx])
    return vmin, vmax


def _lut_live(g, t, vmin, vmax):
    """ess_lut_live: float32, the knots inside by the sparse table."""
    n = len(t[0])
    fn = F32(n)

    def q(v):
        return (F32(v) - F32(g["toff"])) * F32(g["tscl"]) * fn - F32(0.5)

    def clamp(v):
        return min(max(v, F32(0.0)), fn - F32(1.0))

    qa, qb = q(vmin), q(vmax)
    q_lo = clamp(min(qa, qb) - F32(g["q_margin"]))
    q_hi = clamp(max(qa, qb) + F32(g["q_margin"]))

    def alpha_at(qq):
        fl = F32(math.floor(qq))
        i0 = min(max(int(fl), 0), n - 1)
        i1 = min(i0 + 1, n - 1)
        f = qq - fl
        return t[0][i0] * (F32(1.0) - f) + t[0][i1] * f

    amax = max(alpha_at(q_lo), alpha_at(q_hi))
    k_lo, k_hi = math.ceil(q_lo), math.floor(q_hi)
    if k_lo <= k_hi:
        amax = max(amax, _range_max(t, k_lo, k_hi))
    return bool(amax > 0.0)


def _group_min_max(lo, hi):
    """ess_group_min_max: the xor butterfly over the group's lanes."""
    G = len(lo)
    o = G >> 1
    while o:
        lo = [min(lo[i], lo[i ^ o]) for i in range(G)]
        hi = [max(hi[i], hi[i ^ o]) for i in range(G)]
        o >>= 1
    return lo, hi


def _group(n_chunks, nthreads):
    """ess_group: lanes a chunk in the sweep kernels' prologue."""
    G = 1
    while G < 32 and 2 * G * n_chunks <= nthreads:
        G *= 2
    return G


def _chunk_live(g, zs, pmin, pmax, t, c, ty, tx, G):
    """ess_chunk_live: the test of (chunk c, tile) by G lanes, each lane's
    bit (G = 1: one thread)."""
    k0, k1 = c * g["chunk"], min((c + 1) * g["chunk"], g["P"])
    inf = F32(np.inf)
    z_lo, z_hi = [inf] * G, [-inf] * G
    for sub in range(G):
        for k in range(k0 + sub, k1, G):
            z_lo[sub], z_hi[sub] = min(z_lo[sub], zs[k]), max(z_hi[sub], zs[k])
    z_lo, z_hi = _group_min_max(z_lo, z_hi)
    vmin, vmax = [inf] * G, [-inf] * G
    for sub in range(G):
        b = _tile_blocks(g, ty, tx, z_lo[sub], z_hi[sub])
        for k in range(k0 + sub, k1, G):
            vmin[sub], vmax[sub] = _plane_range(pmin, pmax, k, b, vmin[sub],
                                                vmax[sub])
    vmin, vmax = _group_min_max(vmin, vmax)
    return [_lut_live(g, t, lo, hi) for lo, hi in zip(vmin, vmax)]


def _fold_bitmap(g, zs, stats, lut, nthreads=None):
    """The bits of every (chunk, tile row, tile column) of the launch: as
    the sweep kernels' prologue on ``nthreads`` threads a block (lane 0 of
    each group writes; every lane must agree), or a thread a pair as the
    standalone kernel (None)."""
    pmin, pmax = (s.numpy() for s in stats)
    zs = [F32(z) for z in np.asarray(zs, F32)]
    t = _table(np.abs(np.asarray(lut, F32)[:, 3]))
    th, tw = sk.ESS_TILE
    n_c, n_ty, n_tx = (-(-g["P"] // g["chunk"]), -(-g["H"] // th),
                       -(-g["W"] // tw))
    G = 1 if nthreads is None else _group(n_c, nthreads)
    out = np.full((n_c, n_ty, n_tx), 255, np.uint8)  # 255: never written
    for ty in range(n_ty):
        for tx in range(n_tx):
            for c in range(n_c):
                lanes = _chunk_live(g, zs, pmin, pmax, t, c, ty, tx, G)
                assert len(set(lanes)) == 1, "the group's lanes disagree"
                out[c, ty, tx] = lanes[0]
    return torch.from_numpy(out)


# ---- the tests -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 8, 9, 40, 255, 256])
def test_range_max_is_exact(n):
    """The sparse table's query (ess_range_max) is the max of every knot
    in [lo, hi], for every interval of an n-knot LUT; its size is the
    kernels' (``_ess_smem_bytes``: floor(log2 n) + 1 levels)."""
    la = np.abs(np.random.default_rng(n).standard_normal(n)).astype(F32)
    la[np.random.default_rng(n + 1).random(n) < 0.3] = 0.0
    t = _table(la)
    assert len(t) == n.bit_length()
    assert launch._ess_smem_bytes(n, 4) == 4 * n * len(t) + 4
    for lo in range(n):
        for hi in range(lo, n):
            assert _range_max(t, lo, hi) == la[lo:hi + 1].max()


@pytest.mark.parametrize("nthreads", [None, 32, 256],
                         ids=["thread", "warp", "block"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_equals_plain_bitmap(case, nthreads):
    """The kernels' order of the test gives the plain version's bitmap
    byte for byte, every byte written: a thread a (tile, chunk) as the
    standalone kernel, and in groups of lanes as the sweep kernels' blocks
    of 32 and 256 threads (1 to 32 lanes a chunk across the cases)."""
    planes, stats, args, kw, geo, lut = _setup(case)
    ref = sk.ess_bitmap_reference(stats, *args, **kw)
    got = _fold_bitmap(geo, args[0], stats, lut, nthreads)
    assert tuple(got.shape) == tuple(ref.shape)
    assert int((got == 255).sum()) == 0, "a (tile, chunk) bit never written"
    assert torch.equal(got, ref), int((got != ref).sum())
    assert bool((ref == 0).any()) and bool((ref != 0).any()), "vacuous"


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_is_conservative(case):
    """Brute force (tests/test_torch_ess.py test_bitmap_is_conservative):
    every sample of every (tile, chunk) the kernels' order culls has alpha
    exactly 0 in the plain sweep, at every ray and plane."""
    planes, stats, args, kw, geo, lut = _setup(case)
    zs, origin, slopes = args[:3]
    bits = _fold_bitmap(geo, zs, stats, lut, 256)
    W, H, P, chunk = geo["W"], geo["H"], geo["P"], geo["chunk"]
    mxg, myg = sk._slope_grids(slopes, W, H)
    rgba = _chunk_rgba_fn(P, 24, 24, zs, torch.tensor(origin), mxg, myg,
                          kw["march"], -1, None, True, kw["tex_offset"],
                          kw["axis_scale"], True, torch.device("cpu"))
    alpha = rgba(0, planes, torch.from_numpy(lut), 0.8, geo["toff"],
                 geo["tscl"])[..., 3]
    th, tw = sk.ESS_TILE
    live = bits[torch.arange(P) // chunk][
        :, torch.arange(H) // th][:, :, torch.arange(W) // tw] != 0
    assert not live.all() and live.any(), "vacuous: nothing (or all) culled"
    assert (alpha[~live] == 0).all(), float(alpha[~live].abs().max())
