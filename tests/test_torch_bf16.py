"""Port parity of ``precision='bf16'`` and of ``live_fractions``:
vrdd_tpu_torch's kernels' plain versions against vrdd_tpu's Pallas kernels,
run under the TPU interpreter (as tests/test_hist_decode.py runs them), on
the same numpy inputs.

bf16 is JAX's resample with bf16 matmul operands: ``tmp = bf16(wy) @
bf16(plane)``, ``res = bf16(tmp) @ bf16(wx)^T``, and in the backward
``dtmp = bf16(d_res) @ bf16(wx)``, ``d_plane = bf16(wy)^T @ bf16(dtmp)``.
Tolerances: images 1e-4 abs on all but 0.1% of pixels and at most 0.05
anywhere (the port's tent-basis TF against JAX's relu basis, as for f32);
gradients 1e-3 relative L2 (measured: 4.5e-4 for the scalar volume, where a
float32 difference in the geometry moves some tent weights across a bf16
rounding step; 0 for the histogram routes).
Each test also shows the f32 port outside the tolerance, so it cannot pass
for a mode that does nothing. The CUDA kernels are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.pallas import slice_kernel as jk
from vrdd_tpu.pallas import slice_vjp as jv
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels import slice_kernel as tk
from vrdd_tpu_torch.kernels import slice_vjp as tv
from vrdd_tpu_torch.march import slice as ms
from vrdd_tpu_torch.march.slice import bf16_y_transpose

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
TOL, FLIP_SHARE, MAX_ERR = 1e-4, 1e-3, 0.05
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within(got, ref) -> bool:
    """The image rule: <= 1e-4 abs on 99.9% of pixels, < 0.05 anywhere."""
    d = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    return d.max() < MAX_ERR and (d.max(-1) > TOL).mean() <= FLIP_SHARE


def _rel_l2(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _smooth_hist(nz=16, B=8, n=24, seed=2):
    """Bins-major softmax histograms around a smooth blob mean."""
    base = gaussian_blob_volume((nz, n, n), seed=seed)
    centers = ((np.arange(B) + 0.5) / B).astype(np.float32)
    logits = -((centers[None, :, None, None] - base[:, None]) ** 2) / 0.02
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n_planes", [16, 32])
def test_k1_bf16_matches_jax(n_planes):
    vol = gaussian_blob_volume((16, 24, 24))
    kw = dict(width=100, height=72, n_planes=n_planes)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.pallas_slice_render(
            jnp.asarray(vol), jnp.asarray(O), jnp.asarray(TF), 0.05,
            precision="bf16", **kw))
    before = tk.sweep_preblended_planes.launches
    got = tk.pallas_slice_render(torch.from_numpy(vol), O, TF, 0.05,
                                 precision="bf16", **kw)
    assert tk.sweep_preblended_planes.launches == before  # plain version
    assert _within(got.numpy(), ref)
    f32 = tk.pallas_slice_render(torch.from_numpy(vol), O, TF, 0.05, **kw)
    assert not _within(f32.numpy(), ref)


@pytest.mark.parametrize("stat,dtype", list(itertools.product(
    ["mean", "var", "entropy"], ["float32", "bfloat16"])))
def test_k2_bf16_matches_jax(stat, dtype):
    h = np.asarray(jnp.asarray(_smooth_hist()).astype(getattr(jnp, dtype)))
    rows, mode = jk.decode_weight_rows(stat, 8, family="unit")
    kw = dict(transfer_scale=10.0 if stat == "var" else 1.0, width=128,
              height=128, stat=mode)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jk.pallas_hist_render(
            jnp.asarray(h), rows, jnp.asarray(O), jnp.asarray(TF), 0.8,
            precision="bf16", **kw))
    hist = torch.from_numpy(np.array(h, np.float32)).to(
        getattr(torch, dtype))
    got = tk.pallas_hist_render(hist, rows, O, TF, 0.8, precision="bf16",
                                **kw)
    assert _within(got.numpy(), ref)
    f32 = tk.pallas_hist_render(hist, rows, O, TF, 0.8, **kw)
    assert not _within(f32.numpy(), ref)


def _loss_port(render, leaves):
    img = render(*leaves)
    loss = torch.sum((img - 0.25) ** 2)
    return torch.autograd.grad(loss, leaves)


def test_scalar_backward_bf16_matches_jax_grad():
    """pallas_slice_render_diff at 128^2, gradients to the volume and the
    LUT, against jax.grad of JAX's bf16 mode."""
    vol = gaussian_blob_volume((16, 24, 24))
    kw = dict(width=128, height=128, n_planes=16, wrt=("volume", "lut"))

    def jloss(v, lut):
        img = jv.pallas_slice_render_diff(v, jnp.asarray(O), lut, 0.05,
                                          precision="bf16", **kw)
        return jnp.sum((img - 0.25) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vol),
                                              jnp.asarray(TF))
    for prec in ("bf16", "f32"):
        got = _loss_port(
            lambda v, lut, prec=prec: tv.pallas_slice_render_diff(
                v, O, lut, 0.05, precision=prec, **kw),
            [torch.tensor(vol, requires_grad=True),
             torch.tensor(TF, requires_grad=True)])
        errs = [_rel_l2(g, r) for g, r in zip(got, ref)]
        if prec == "bf16":
            assert max(errs) <= GRAD_TOL, errs
        else:  # the f32 volume gradient is far off the bf16 one
            assert errs[0] > 10 * GRAD_TOL, errs


@pytest.mark.parametrize("route", ["inkernel", "materialized"])
def test_hist_backward_bf16_matches_jax_grad(route):
    """pallas_hist_render_diff (mean) at 128^2, gradients to the histograms
    and the LUT, against jax.grad of JAX's bf16 mode, on both routes."""
    h = _smooth_hist()
    rows, mode = jk.decode_weight_rows("mean", 8, family="unit")
    kw = dict(width=128, height=128, stat=mode, wrt=("hist", "lut"),
              route=route)

    def jloss(hh, lut):
        img = jv.pallas_hist_render_diff(hh, rows, jnp.asarray(O), lut, 0.8,
                                         precision="bf16", **kw)
        return jnp.sum((img - 0.25) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                              jnp.asarray(TF))
    for prec in ("bf16", "f32"):
        got = _loss_port(
            lambda hh, lut, prec=prec: tv.pallas_hist_render_diff(
                hh, rows, O, lut, 0.8, precision=prec, **kw),
            [torch.tensor(h, requires_grad=True),
             torch.tensor(TF, requires_grad=True)])
        errs = [_rel_l2(g, r) for g, r in zip(got, ref)]
        if prec == "bf16":
            assert max(errs) <= GRAD_TOL, errs
        else:
            assert errs[0] > 10 * GRAD_TOL, errs


#: chip_smoke.py 12b's second limit on the bf16 decoded-plane cotangent:
#: at most 8% of its nonzero entries off by more than 2^-12 of the entry
SHARE_TAU, SHARE_LIMIT = 2.0 ** -12, 0.08


def _share_off(got, ref) -> float:
    nz = ref != 0
    return float(((got - ref).abs() > SHARE_TAU * ref.abs())[nz]
                 .float().mean())


def _d_res_unrounded(ctx, d_res):
    """_Bf16Resample.backward with the cotangent's rounding skipped."""
    wy, wx = ctx.saved_tensors
    return None, bf16_y_transpose(wy, torch.bmm(d_res, wx)), None


@pytest.mark.parametrize("case", ["noise floor", "dtmp unrounded",
                                  "d_res unrounded", "f32"])
def test_bf16_share_limit_tells_noise_from_a_skipped_rounding(case,
                                                              monkeypatch):
    """The plain bf16 backward at 48^3 x 16 -> 96^2 (mean) against itself
    with the cotangent perturbed so that the f32 backward moves by 3.5e-5
    relative L2 (the kernels' f32 gap on the card): within the share limit
    (measured 1.7% of entries, at 3.6e-4 relative L2). With one of JAX's
    roundings skipped, or in f32, many more entries move (measured: the row
    sums unrounded 86.8% at 1.3e-3, the cotangent unrounded 37.1% at
    1.8e-3, f32 94.0% at 1.6e-2), though the first two read within 2x of
    the 1e-3 relative L2 limit."""
    from vrdd_tpu_torch.io.synthetic import blob_histogram_volume

    hist = blob_histogram_volume(48, 16, dtype=torch.bfloat16, device="cpu")
    rows, mode = tk.decode_weight_rows("mean", 16, family="unit")

    def args(prec):
        cfg = tv.render_config(hist.shape, O, stat=mode, width=96,
                               height=96, precision=prec)
        return (cfg, hist, torch.as_tensor(rows), torch.as_tensor(TF),
                torch.tensor(0.05), torch.tensor(0.0), torch.tensor(1.0))

    a16, a32, flags = args("bf16"), args("f32"), (True, False, False)
    img, _ = tv.sweep_fwd_ckpt(*a16)
    g = (2.0 / img.numel()) * (img - 0.25)
    ref = tv.sweep_bwd_reference(*a16, g, *flags)[0]
    if case == "noise floor":
        d32 = tv.sweep_bwd_reference(*a32, g, *flags)[0]
        noise = torch.randn(g.shape, generator=torch.Generator().manual_seed(9))
        moved = tv.sweep_bwd_reference(*a32, g * (1 + 2.0 ** -16 * noise),
                                       *flags)[0]
        eps = 2.0 ** -16 * 3.5e-5 / _rel_l2(moved, d32)
        got = tv.sweep_bwd_reference(*a16, g * (1 + eps * noise), *flags)[0]
    elif case == "f32":
        got = tv.sweep_bwd_reference(*a32, g, *flags)[0]
    else:
        if case == "dtmp unrounded":
            monkeypatch.setattr(ms, "bf16_y_transpose", lambda wy, dtmp: (
                torch.bmm(ms._bf16(wy).transpose(1, 2), dtmp)))
        else:
            monkeypatch.setattr(ms._Bf16Resample, "backward",
                                staticmethod(_d_res_unrounded))
        got = tv.sweep_bwd_reference(*a16, g, *flags)[0]
    assert float(ref.abs().max()) > 0.0, "vacuous: zero cotangent"
    share = _share_off(got, ref)
    if case == "noise floor":
        assert 0.0 < share <= SHARE_LIMIT, share
    else:
        assert share > SHARE_LIMIT, share


def test_bf16_route_auto_resolves_and_runs():
    """route='auto' takes the bf16 mode through whichever route it picks."""
    h = torch.from_numpy(_smooth_hist(nz=8, n=12))
    rows, mode = tk.decode_weight_rows("mean", 8, family="unit")
    kw = dict(width=24, height=20, stat=mode, wrt=("hist",))
    auto = tv.pallas_hist_render_diff(h, rows, O, TF, 0.8, precision="bf16",
                                      route="auto", **kw)
    route = tv.auto_route(h.shape, h.dtype, mode)
    ref = tv.pallas_hist_render_diff(h, rows, O, TF, 0.8, precision="bf16",
                                     route=route, **kw)
    assert torch.equal(auto, ref)


def _band_lut():
    """Zero alpha below ~0.5, a ramp above (tests/test_pallas_slice.py)."""
    lut = np.zeros((8, 4), dtype=np.float32)
    lut[:, 0] = np.linspace(0, 1, 8)
    lut[5:, 3] = [0.3, 0.7, 1.0]
    return lut


def test_bf16_ess_is_exact():
    """Empty-space skipping stays exact in the bf16 mode: its LUT-coordinate
    margin widens by the bf16 spread of the plane values, and the render
    with ESS equals the one without, bit for bit."""
    v = torch.from_numpy(gaussian_blob_volume((24, 24, 24), seed=3))
    vol = torch.where(v > 0.35, v, 0.0)
    stats = tk.precompute_ess_stats(vol, n_planes=48)
    lut = _band_lut()
    assert tk._ess_q_margin(stats, lut, 1.0, True) > tk._ess_q_margin(
        stats, lut, 1.0, False)
    kw = dict(width=100, height=72, n_planes=48, precision="bf16")
    ref = tk.pallas_slice_render(vol, O, lut, 0.8, **kw)
    got = tk.pallas_slice_render(vol, O, lut, 0.8, empty_space_skip=True,
                                 **kw)
    assert torch.equal(got, ref)
    assert float(ref[..., 3].max()) > 0.05, "vacuous: empty render"
    planes, zs = tk.preblend_planes(vol, 48, (-1.0, -1.0, -1.0),
                                    (1.0, 1.0, 1.0), -1)
    bitmap = tk.ess_bitmap(
        tk.ess_plane_stats(planes), zs, O, tk.pixel_slope_params(100, 72),
        lut, 0.0, 1.0, width=100, height=72, ny=24, nx=24, plane_chunk=8,
        q_margin=tk._ess_q_margin(stats, lut, 1.0, True))
    assert bool((bitmap == 0).any()), "vacuous: nothing culled"


# ---- live_fractions ---------------------------------------------------------

def test_live_fractions_reports_culling():
    """JAX's own assertions (tests/test_hist_decode.py) hold for the port:
    a thin volume keeps its tiles live, an opaque one under a saturating
    density lets them die front to back."""
    nz = 16
    vol = np.random.default_rng(4).random((nz, nz, nz), dtype=np.float32)
    kw = dict(width=128, height=128, n_planes=nz)
    lf_thin = tv.live_fractions(torch.from_numpy(vol), O, TF, density=0.01,
                                **kw)
    lf_opaque = tv.live_fractions(torch.from_numpy(vol * 0.0 + 0.7), O, TF,
                                  density=5.0, **kw)
    assert 0.0 < lf_thin["tile_live_frac"] <= 1.0
    assert lf_thin["strip_live_frac"] >= lf_thin["tile_live_frac"]
    assert lf_opaque["tile_live_frac"] < lf_thin["tile_live_frac"]
    assert lf_opaque["tile_live_frac"] < 0.9
    assert lf_thin["n_xt"] == 4  # 128 / 32


@pytest.mark.parametrize("case", ["opaque", "thin"])
def test_live_fractions_exact_cases_match_jax(case):
    """Where the two tilings must agree: the box fills the view at every
    depth (focal 8), so every tile samples the volume; on an opaque volume
    every ray dies in the first chunk (both report 1 / n_chunks), on a thin
    one none dies (both report 1)."""
    nz = 16
    vol = (np.full((nz, nz, nz), 0.7, np.float32) if case == "opaque" else
           np.random.default_rng(4).random((nz, nz, nz), dtype=np.float32))
    density = 5.0 if case == "opaque" else 0.01
    # plane_chunk 8: the chunk JAX's _fit_plane_chunk keeps at this size
    kw = dict(width=128, height=128, n_planes=nz, focal=8.0, plane_chunk=8)
    with pltpu.force_tpu_interpret_mode():
        ref = jv.live_fractions(jnp.asarray(vol), jnp.asarray(O),
                                jnp.asarray(TF), density=density, **kw)
    got = tv.live_fractions(torch.from_numpy(vol), O, TF, density=density,
                            **kw)
    want = 1.0 / (nz // 8) if case == "opaque" else 1.0
    for key in ("tile_live_frac", "strip_live_frac"):
        assert ref[key] == pytest.approx(want), (key, ref)
        assert got[key] == pytest.approx(want), (key, got)
