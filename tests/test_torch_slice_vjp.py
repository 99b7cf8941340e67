"""Port parity of the training path's scalar sweep and its pieces:
vrdd_tpu_torch.march.slice's analytic VJP and
vrdd_tpu_torch.kernels.slice_vjp against vrdd_tpu on the same numpy inputs.

On the CPU the K3/K4/K5 wrappers take their plain versions; the JAX
kernels run under the Pallas TPU interpreter, as tests/test_hist_decode.py
runs them. The CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march import slice as jslice
from vrdd_tpu.pallas import slice_vjp as jv
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import _build
from vrdd_tpu_torch.kernels import slice_kernel as tk
from vrdd_tpu_torch.kernels import slice_vjp as tv
from vrdd_tpu_torch.march import slice as tslice
from vrdd_tpu_torch.models.hist_renderer import HistRenderer
from vrdd_tpu_torch.utils.compare import storage_ulp

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
# (tf offset, tf scale, brightness): off-default, so their gradients matter
TOFF, TSCL, BRIGHT = 0.1, 1.5, 1.2


def mre(a, b):
    """Max error relative to the reference's largest magnitude (the JAX
    suite's measure, tests/test_hist_decode.py:81-83)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


def _leaves(vol, density):
    """The port's differentiable inputs: volume, LUT, density, TF offset,
    TF scale, brightness."""
    return [torch.tensor(v, requires_grad=True) for v in
            (vol, TF, np.float32(density), np.float32(TOFF),
             np.float32(TSCL), np.float32(BRIGHT))]


CASES = list(itertools.product([0.05, 5.0], [16, 32]))


def _jax_render_grads(vol, density, n_planes, W, H):
    def loss(v, lut, d, to, ts, b):
        img = jslice.slice_render_image(v, jnp.asarray(O), W, H, lut, d, b,
                                        to, ts, n_planes=n_planes)
        return jnp.sum(img ** 2)

    return jax.value_and_grad(loss, argnums=tuple(range(6)))(
        jnp.asarray(vol), jnp.asarray(TF), jnp.float32(density),
        jnp.float32(TOFF), jnp.float32(TSCL), jnp.float32(BRIGHT))


def _port_render_grads(vol, density, n_planes, W, H, use_custom_vjp=True):
    leaves = _leaves(vol, density)
    v, lut, d, to, ts, b = leaves
    img = tslice.slice_render_image(v, O, W, H, lut, d, b, to, ts,
                                    n_planes=n_planes,
                                    use_custom_vjp=use_custom_vjp)
    loss = torch.sum(img ** 2)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("density,n_planes", CASES)
def test_analytic_vjp_matches_jax(density, n_planes):
    """The port's analytic two-pass VJP against the JAX custom VJP of
    march/slice.py: value rel 1e-5, each gradient max-rel 1e-4."""
    vol = gaussian_blob_volume((16, 24, 24))
    jval, jgrads = _jax_render_grads(vol, density, n_planes, 40, 30)
    val, grads = _port_render_grads(vol, density, n_planes, 40, 30)
    assert abs(val - float(jval)) / abs(float(jval)) < 1e-5
    for name, g, r in zip(("volume", "lut", "density", "toff", "tscl",
                           "brightness"), grads, jgrads):
        assert mre(g.numpy(), r) < 1e-4, name


@pytest.mark.parametrize("density,n_planes", CASES)
def test_analytic_vjp_matches_autograd(density, n_planes):
    """use_custom_vjp=True against plain autograd through the forward."""
    vol = gaussian_blob_volume((16, 24, 24), seed=1)
    val, grads = _port_render_grads(vol, density, n_planes, 40, 30)
    val_r, grads_r = _port_render_grads(vol, density, n_planes, 40, 30,
                                        use_custom_vjp=False)
    assert abs(val - val_r) / abs(val_r) < 1e-5
    for g, r in zip(grads, grads_r):
        assert mre(g.numpy(), r.numpy()) < 1e-4


@pytest.mark.parametrize("density,n_planes", CASES)
def test_pallas_slice_render_diff_matches_jax(density, n_planes):
    """pallas_slice_render_diff (plain K4/K5 versions on the CPU) against
    JAX's fused VJP in interpret mode: value rel 1e-5, grads max-rel 5e-4
    (the JAX kernel sums the LUT cotangent in its own order,
    tests/test_hist_decode.py:88-91)."""
    vol = gaussian_blob_volume((16, 16, 16), seed=2)
    W = H = 128

    def jloss(v, lut, d, to, ts, b):
        img = jv.pallas_slice_render_diff(
            v, jnp.asarray(O), lut, d, b, to, ts, width=W, height=H,
            n_planes=n_planes)
        return jnp.sum(img ** 2)

    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
            jnp.asarray(vol), jnp.asarray(TF), jnp.float32(density),
            jnp.float32(TOFF), jnp.float32(TSCL), jnp.float32(BRIGHT))
    leaves = _leaves(vol, density)
    v, lut, d, to, ts, b = leaves
    img = tv.pallas_slice_render_diff(v, O, lut, d, b, to, ts, width=W,
                                      height=H, n_planes=n_planes)
    loss = torch.sum(img ** 2)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jval)) / abs(float(jval)) < 1e-5
    for name, g, r in zip(("volume", "lut", "density", "toff", "tscl",
                           "brightness"), grads, jgrads):
        assert mre(g.numpy(), r) < 5e-4, name


@pytest.mark.parametrize("wrt", [("lut",), ("volume",), ("params",)])
def test_wrt_pruning_returns_exact_zeros(wrt):
    vol = gaussian_blob_volume((8, 12, 12), seed=3)
    leaves = _leaves(vol, 0.3)[:5]
    v, lut, d, to, ts = leaves
    img = tv.pallas_slice_render_diff(v, O, lut, d, 1.0, to, ts, width=24,
                                      height=20, n_planes=8, wrt=wrt)
    grads = torch.autograd.grad(torch.sum(img ** 2), leaves)
    full = torch.autograd.grad(torch.sum(tv.pallas_slice_render_diff(
        v, O, lut, d, 1.0, to, ts, width=24, height=20, n_planes=8) ** 2),
        leaves)
    groups = ("volume", "lut", "params", "params", "params")
    for grp, g, f in zip(groups, grads, full):
        if grp in wrt:
            torch.testing.assert_close(g, f, rtol=0, atol=0)
        else:
            assert g.shape == f.shape and float(g.abs().max()) == 0.0, grp


#: density, TF offset, TF scale: none of them representable in float32
SCALARS = (0.05, 0.1, 1.0 / 3.0)


def _scalar_step(kind, as_tensors):
    """One fit step, ``loss = mean((img - 0.25)^2)``, of the in-kernel
    histogram route (``hist``) or the scalar sweep (``planes``) with
    density, TF offset and TF scale as Python floats or as float32 tensors
    that need gradients. Returns the image and the autograd Function's
    gradients of each of its inputs (None where it gives none)."""
    lut = torch.as_tensor(TF, dtype=torch.float32).requires_grad_()
    scal = [torch.tensor(v, dtype=torch.float32, requires_grad=True)
            for v in SCALARS] if as_tensors else list(SCALARS)
    d, to, ts = scal
    if kind == "hist":
        rng = np.random.default_rng(6)
        h = rng.random((6, 8, 10, 12)).astype(np.float32)
        vol = torch.from_numpy(h / h.sum(axis=1, keepdims=True))
        rows, mode = tk.decode_weight_rows("mean", 8, family="unit")
        img = tv.pallas_hist_render_diff(
            vol.requires_grad_(), rows, O, lut, d, 1.0, to, ts, width=20,
            height=16, stat=mode, wrt=("hist", "lut", "params"))
    else:
        vol = torch.from_numpy(gaussian_blob_volume((8, 12, 12), seed=3))
        img = tv.pallas_slice_render_diff(
            vol.requires_grad_(), O, lut, d, 1.0, to, ts, width=24,
            height=20, n_planes=8)
    g, = torch.autograd.grad(torch.mean((img - 0.25) ** 2), img,
                             retain_graph=True)
    # img = out * brightness: the Function's node is the product's input
    node = img.grad_fn.next_functions[0][0]
    assert type(node).__name__ == ("_HistDiffBackward" if kind == "hist"
                                   else "_PlanesDiffBackward")
    return img.detach(), node.apply(g)


@pytest.mark.parametrize("kind", ["hist", "planes"])
def test_scalars_as_numbers_or_tensors_give_one_step(kind):
    """The sweep's scalars as host numbers or as tensors that need
    gradients: the same image and, bit for bit, the same gradients of the
    volume (histograms or planes) and the LUT. The numbers get None from
    the Function; the tensors get their cotangents."""
    img_n, got_n = _scalar_step(kind, False)
    img_t, got_t = _scalar_step(kind, True)
    # the Functions' inputs end with (volume, [rows,] lut, density, toff,
    # tscl, acc0)
    vol_i, lut_i = (3, 5) if kind == "hist" else (3, 4)
    params = slice(lut_i + 1, lut_i + 4)
    assert torch.equal(img_n, img_t)
    for i in (vol_i, lut_i):
        assert got_n[i] is not None and torch.equal(got_n[i], got_t[i])
    assert got_n[params] == (None, None, None)
    for g in got_t[params]:
        assert g.shape == () and torch.isfinite(g) and float(g) != 0.0
    assert got_n[-1] is None and got_t[-1] is None


def test_no_grad_primal_is_the_forward_sweep():
    """Without a gradient the diff wrappers run K3, which is K1 (and K2) at
    brightness 1 with the brightness folded outside."""
    vol = torch.from_numpy(gaussian_blob_volume((8, 12, 12), seed=4))
    with torch.no_grad():
        got = tv.pallas_slice_render_diff(vol, O, TF, 0.3, 1.0, width=30,
                                          height=20, n_planes=16)
    ref = tk.pallas_slice_render(vol, O, TF, 0.3, 1.0, width=30, height=20,
                                 n_planes=16)
    assert torch.equal(got, ref)


def test_launch_counters_stay_zero_on_cpu():
    vol = torch.from_numpy(gaussian_blob_volume((8, 8, 8), seed=5))
    v = vol.clone().requires_grad_()
    img = tv.pallas_slice_render_diff(v, O, TF, width=16, height=16)
    img.sum().backward()
    with torch.no_grad():
        tv.pallas_slice_render_diff(vol, O, TF, width=16, height=16)
    assert tv.sweep_fwd.launches == tv.sweep_fwd_ckpt.launches == 0
    assert tv.sweep_bwd.launches == 0


@pytest.mark.parametrize("density", [0.05, 5.0])
def test_checkpoints_follow_the_backward_recursion(density):
    """K4's plain version: the image is K3's, row 0 of tck is 1, rows never
    grow, and the last row is the T the rows' own recursion reaches."""
    vol = torch.from_numpy(gaussian_blob_volume((16, 12, 12), seed=6))
    cfg = tv._Sweep(
        zs=np.linspace(0.9375, -0.9375, 16).astype(np.float32), origin=tuple(O),
        slopes=(-0.5, 0.05, -0.5, 0.05), width=20, height=20,
        march=tk.MarchConfig(), plane_spacing=0.125, ck_stride=4,
        reverse=True,
    )
    args = (vol, None, torch.tensor(TF), torch.tensor(density),
            torch.tensor(0.0), torch.tensor(1.0))
    img, tck = tv.sweep_fwd_ckpt(cfg, *args)
    assert torch.equal(img, tv.sweep_fwd(cfg, *args))
    assert tck.shape == (4, 20, 20)
    assert torch.equal(tck[0], torch.ones(20, 20))
    assert bool((tck[1:] <= tck[:-1]).all())
    if density > 1.0:
        assert float(tck[-1].min()) < 0.05, "saturating rays must freeze"


def _decode_autograd(h, rows, mode):
    """The decode in differentiable torch ops (the oracle of _Decode)."""
    if mode == "linear":
        return torch.einsum("zbyx,b->zyx", h, rows[0])
    if mode == "var":
        m, c1, c2, c0 = (torch.einsum("zbyx,b->zyx", h, rows[r])
                         for r in range(4))
        return c2 - 2.0 * m * c1 + m * m * c0
    safe = torch.where(h > 0.0, h, 1.0)
    return rows[0, 0] * torch.sum(-h * torch.log2(safe), dim=1)


_STATS = ("mean", "var", "entropy")


@pytest.mark.parametrize("stat,dtype", [
    *(pytest.param(s, torch.float32, id=s) for s in _STATS),
    *(pytest.param(s, torch.bfloat16, id=f"{s}-bf16") for s in _STATS)])
def test_decode_backward_matches_autograd(stat, dtype):
    """The materialized decode's explicit chain (histograms, by the plain
    version of ``decode_chain`` on the CPU, and rows) against autograd
    through the einsums: max-rel 1e-5, but the bf16 histograms' cotangent,
    within one bf16 rounding of autograd's (which rounds its float32
    gradient to bf16 as the chain does) over the float32 noise of the
    variance's cancellation; exact zeros where an entropy bin is empty."""
    rng = np.random.default_rng(7)
    h = rng.random((6, 8, 5, 7)).astype(np.float32)
    h[:, 2] = 0.0  # exact zeros: the entropy chain is 0 there
    h /= h.sum(axis=1, keepdims=True)
    rows_np, mode = tk.decode_weight_rows(stat, 8, family="unit")
    g = torch.from_numpy(rng.standard_normal((6, 5, 7)).astype(np.float32))
    out = []
    for fn in (tk.decode_with_rows,
               lambda hh, rows, m: _decode_autograd(hh.float(), rows, m)):
        hh = torch.tensor(h, dtype=dtype, requires_grad=True)
        rows = torch.tensor(rows_np, requires_grad=True)
        dec = fn(hh, rows, mode)
        out.append((dec.detach(), *torch.autograd.grad(dec, [hh, rows], g)))
    for i, (got, ref) in enumerate(zip(out[0], out[1])):
        assert got.dtype == ref.dtype
        if i == 1 and dtype == torch.bfloat16:
            a, b = got.float(), ref.float()
            slack = storage_ulp(torch.maximum(a.abs(), b.abs()), dtype) + (
                1e-5 * float(b.abs().max()))
            assert bool(((a - b).abs() <= slack).all())
            assert float((a != b).float().mean()) < 0.05
        else:
            assert mre(got.float().numpy(), ref.float().numpy()) < 1e-5
    if stat == "entropy":
        assert float(out[0][1][:, 2].abs().max()) == 0.0


def test_decode_chain_takes_kernel_moments():
    """The variance chain from the moments the reverse kernel writes
    ([m, 2(mC0 - C1)] per voxel) equals the chain that recomputes them."""
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.random((4, 8, 6, 6)).astype(np.float32))
    rows = torch.from_numpy(tk.decode_weight_rows("var", 8, family="unit")[0])
    d_dec = torch.from_numpy(rng.standard_normal((4, 6, 6)).astype(np.float32))
    m, c1, _, c0 = tk._moments(h, rows)
    mom = torch.stack([m, 2.0 * (m * c0 - c1)], dim=1)
    torch.testing.assert_close(tk.decode_chain(h, rows, "var", d_dec, mom),
                               tk.decode_chain(h, rows, "var", d_dec))


@pytest.mark.parametrize("stat", ["mean", "var", "entropy"])
def test_decode_chain_on_cpu_is_the_plain_version(stat):
    """A CPU histogram volume takes the plain version, bit for bit, and
    counts no kernel launch."""
    rng = np.random.default_rng(18)
    h = torch.from_numpy(rng.random((3, 4, 5, 6)).astype(np.float32))
    rows = torch.from_numpy(tk.decode_weight_rows(stat, 4, family="unit")[0])
    d_dec = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    mode = tk.decode_weight_rows(stat, 4, family="unit")[1]
    before = tk.decode_chain.launches
    got = tk.decode_chain(h.to(torch.bfloat16), rows, mode, d_dec)
    assert tk.decode_chain.launches == before
    assert torch.equal(got, tk.decode_chain_reference(
        h.to(torch.bfloat16), rows, mode, d_dec))


def test_decode_chain_binding():
    """The decode chain's source is built, and its ctypes binding has one
    type per parameter of the C entry: c_void_p for every pointer and the
    stream, c_int for ``int``, c_longlong for ``long long``."""
    import ctypes
    import re

    src = _build.CSRC / "decode_chain.cu"
    assert src in _build.SOURCES
    m = re.search(r"\bvrdd_decode_chain\(([^)]*)\)", src.read_text())
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = _build.DECODE_CHAIN_ARGTYPES
    assert len(params) == len(types) == 11, params
    for decl, t in zip(params, types):
        if "*" in decl:
            assert t is ctypes.c_void_p, decl
        elif decl.startswith("long long"):
            assert t is ctypes.c_longlong, decl
        else:
            assert decl.startswith("int ") and t is ctypes.c_int, decl


def test_hist_renderer_trains_through_the_diff_path():
    rng = np.random.default_rng(9)
    h = rng.random((8, 4, 8, 8)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    rows, mode = tk.decode_weight_rows("mean", 4, family="unit")
    for route in ("inkernel", "materialized"):
        m = HistRenderer(TF, rows, stat=mode, width=20, height=16,
                         density=0.3, route=route, wrt=("hist",),
                         device="cpu")
        hist = torch.tensor(h, requires_grad=True)
        (g,) = torch.autograd.grad(m(hist, O).sum(), [hist])
        ref_h = torch.tensor(h, requires_grad=True)
        ref = tv.pallas_hist_render_diff(ref_h, rows, O, TF, 0.3, width=20,
                                         height=16, stat=mode, route=route,
                                         wrt=("hist",))
        (g_ref,) = torch.autograd.grad(ref.sum(), [ref_h])
        assert torch.equal(g, g_ref)
    with torch.no_grad():
        assert torch.equal(m(torch.tensor(h), O), tk.pallas_hist_render(
            torch.tensor(h), rows, O, TF, 0.3, width=20, height=16,
            stat=mode))


def test_unported_modes_raise():
    vol = torch.zeros((4, 4, 4), requires_grad=True)
    # empty-space skipping is ported, and exact only for wrt=('volume',):
    # other wrt raise ValueError, as in JAX
    with pytest.raises(ValueError, match="wrt"):
        tv.pallas_slice_render_diff(vol, O, TF, width=8, height=8,
                                    empty_space_skip=True)
    # precision='bf16' is ported (tests/test_torch_bf16.py holds it against
    # jax.grad); any other value raises
    img = tv.pallas_slice_render_diff(vol, O, TF, width=8, height=8,
                                      precision="bf16")
    (g,) = torch.autograd.grad(img.sum(), [vol])
    assert g.shape == vol.shape and bool(torch.isfinite(g).all())
    with pytest.raises(ValueError, match="precision"):
        tv.pallas_slice_render_diff(vol, O, TF, width=8, height=8,
                                    precision="f16")
    # the seeded sweep is ported: an empty stack passes the seed through,
    # and its cotangent back (tests/test_torch_streaming.py holds the
    # seeded sweep against JAX's)
    seed = torch.rand((8, 8, 4), generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
    img = tv.sweep_preblended_planes_diff(
        vol, np.zeros(4, np.float32), O, (0.0, 0.1, 0.0, 0.1), TF,
        width=8, height=8, acc_init=seed)
    assert torch.equal(img.detach(), seed.detach())
    (g,) = torch.autograd.grad(img.sum(), [seed])
    assert torch.equal(g, torch.ones_like(g))
    # live_fractions is ported (tests/test_torch_bf16.py): JAX's keys
    lf = tv.live_fractions(vol.detach(), O, TF, width=8, height=8)
    assert set(lf) == {"tile_live_frac", "strip_live_frac", "n_xt"}
    assert lf["n_xt"] == 1 and 0.0 < lf["tile_live_frac"] <= 1.0
    with pytest.raises(ValueError, match="plane_chunk"):
        tv.pallas_slice_render_diff(vol, O, TF, width=8, height=8,
                                    plane_chunk=5)
    with pytest.raises(ValueError, match="linear-mode only"):
        tv.pallas_hist_render_diff(torch.zeros((4, 2, 4, 4)),
                                   np.ones((1, 2), np.float32), O, TF,
                                   width=8, height=8, stat="entropy",
                                   wrt=("weights",))


def test_auto_route_is_jax_rule():
    """JAX's policy verbatim (slice_vjp.py:1392-1397): materialized unless
    entropy or past the TPU's 13 GiB budget."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tv.auto_route((16, 8, 16, 16), f32, "linear") == "materialized"
    assert tv.auto_route((16, 8, 16, 16), f32, "entropy") == "inkernel"
    assert tv.auto_route((512, 16, 512, 512), bf16, "var") == "materialized"
    assert tv.auto_route((512, 16, 512, 512), f32, "linear") == "inkernel"
    assert tv.auto_route((1024, 16, 1024, 1024), bf16, "linear") == "inkernel"


def test_diff_supported_predicate():
    assert tv.pallas_diff_supported((512, 512, 512), 1024, 1024, 512)
    assert tv.pallas_diff_supported((16, 24, 24), 100, 72, 32, n_lut=23)
    assert not tv.pallas_diff_supported((16, 24, 24), 100, 72, 32, n_lut=24)


def test_build_hash_covers_headers(tmp_path):
    """The library name changes when only a shared header changes, so an
    edited header never loads a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build._source_hash(csrc)
    assert before == _build._source_hash(_build.CSRC)
    header = csrc / "sweep_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = _build._source_hash(csrc)
    assert after != before
    src = csrc / "slice_vjp.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._source_hash(csrc) not in (before, after)


def test_freeze_threshold_is_jax_value():
    """K4 and K5 freeze a ray once T < 1 - threshold, with 1 - threshold
    formed as JAX's kernel forms it (the Python float against an f32 T,
    vrdd_tpu/pallas/slice_vjp.py:426) and as the plain versions compare:
    f32(1 - 0.95). 1.0f - 0.95f lies three ulps higher; rays whose T fell
    between the two froze one sample early on the card, moving the
    cotangents of their every sample through P_total."""
    cfg = tv.render_config((16, 24, 24), O, width=32, height=16)
    p = _build.SweepParams(n_lut=8, **cfg.params(
        torch.zeros(16, 24, 24), None, 0.05, 0.0, 1.0))
    thr = cfg.march.opacity_threshold
    assert p.threshold == np.float32(thr)
    assert p.thr1 == np.float32(1.0 - thr)
    assert p.thr1 < np.float32(1.0) - np.float32(thr)
    below = np.nextafter(np.float32(p.thr1), np.float32(0.0))
    t = np.array([p.thr1, below], np.float32)
    assert (torch.from_numpy(t) >= 1.0 - thr).tolist() == [True, False]
    assert np.asarray(jnp.asarray(t) >= 1.0 - thr).tolist() == [True, False]


def test_lut_slope_at_a_knot_is_jax_kernels():
    """A constant 0.5 volume puts the samples on the TF's knot q = 4 (0.5 x
    9 - 0.5, exact): the plain K5 (d_volume, d_toff, d_tscl) takes JAX's
    fused VJP's slope there, the interval below the knot
    (vrdd_tpu/pallas/slice_vjp.py:466), as the CUDA K5 does. Autograd
    through the tent would add both intervals' slopes; JAX's own
    march/slice reference (jax.grad of jnp.maximum) takes their mean."""
    vol = np.full((16, 16, 16), 0.5, np.float32)
    kw = dict(width=32, height=24, n_planes=16)
    # a 9-knot LUT whose slopes change at every knot, in every channel
    ramp = np.array([0.0, 0.1, 0.3, 0.6, 1.0, 0.9, 0.5, 0.2, 0.0], np.float32)
    lut = np.stack([ramp, ramp[::-1], ramp ** 2, 0.1 + 0.5 * ramp], -1)

    def jloss(v, lut, to, ts):
        img = jv.pallas_slice_render_diff(v, jnp.asarray(O), lut, 0.3, 1.0,
                                          to, ts, **kw)
        return jnp.sum(img ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            jnp.asarray(vol), jnp.asarray(lut), jnp.float32(0.0),
            jnp.float32(1.0))
    leaves = [torch.tensor(vol, requires_grad=True),
              torch.tensor(lut, requires_grad=True),
              torch.tensor(0.0, requires_grad=True),
              torch.tensor(1.0, requires_grad=True)]
    img = tv.pallas_slice_render_diff(leaves[0], O, leaves[1], 0.3, 1.0,
                                      leaves[2], leaves[3], **kw)
    got = torch.autograd.grad(torch.sum(img ** 2), leaves)
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.0, "vacuous"
    for name, g, r in zip(("volume", "lut", "toff", "tscl"), got, ref):
        assert mre(g.numpy(), r) < 5e-4, name
    jref = jax.grad(lambda v: jnp.sum(jslice.slice_render_image(
        v, jnp.asarray(O), 32, 24, jnp.asarray(lut), 0.3, 1.0, 0.0, 1.0,
        n_planes=16) ** 2))(jnp.asarray(vol))
    assert mre(got[0].numpy(), jref) > 0.1  # the reference's mean slope
