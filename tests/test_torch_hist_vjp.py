"""Port parity of the training path's headline entry point:
``pallas_hist_render_diff`` of vrdd_tpu_torch against vrdd_tpu's, on the
same numpy histograms, for every statistic, route, storage dtype and a set
of ``wrt`` subsets.

The JAX side runs its Pallas kernels under the TPU interpreter, as
tests/test_hist_decode.py runs them, at 128^2 (the JAX diff path needs
multiples of its 128-row strip) on 16^3 x 8 volumes. The port's wrappers
take their plain versions on the CPU."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.pallas import slice_vjp as jv
from vrdd_tpu.pallas.slice_kernel import decode_weight_rows
from vrdd_tpu_torch.convert import state_from_jax
from vrdd_tpu_torch.kernels import slice_vjp as tv

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
W = H = 128
BF16_ULP = 2.0 ** -8  # one rounding of the bf16 histogram cotangent


def _hist(seed, dtype=jnp.float32, nz=16, B=8):
    rng = np.random.default_rng(seed)
    h = rng.random((nz, B, nz, nz)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    return np.asarray(jnp.asarray(h).astype(dtype))


def _rows(stat, B=8):
    rows, mode = decode_weight_rows({"linear": "mean"}.get(stat, stat), B,
                                    family="unit")
    return rows, mode


def _both(h, stat, route, wrt, density=0.08, argnums=(0, 1, 2),
          jax_route=None):
    """Value and gradients (hist, rows, LUT) of sum(img^2) from JAX (on
    ``jax_route``, default ``route``) and from the port; pruned entries come
    back as zeros. The default density keeps rays short of the 0.95 cutoff,
    where two summation orders may flip a freeze mask (JAX's own routes
    disagree by 3% on a few voxels at density 0.3)."""
    rows, mode = _rows(stat)
    tscl = 10.0 if stat == "var" else 1.0  # var ~0.05: window it mid-ramp
    kw = dict(width=W, height=H, wrt=wrt, stat=mode, route=route,
              transfer_scale=tscl)

    def jloss(hh, rr, lut):
        return jnp.sum(jv.pallas_hist_render_diff(
            hh, rr, jnp.asarray(O), lut, density,
            **dict(kw, route=jax_route or route)) ** 2)

    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.value_and_grad(jloss, argnums=argnums)(
            jnp.asarray(h), jnp.asarray(rows), jnp.asarray(TF))
    st = state_from_jax({"hist_bm": h, "rows": rows, "tf_lut": TF}, "cpu")
    leaves = [st[k].requires_grad_() for k in ("hist_bm", "rows", "tf_lut")]
    leaves = [leaves[i] for i in argnums]
    args = {k: st[k] for k in ("hist_bm", "rows", "tf_lut")}
    img = tv.pallas_hist_render_diff(args["hist_bm"], args["rows"], O,
                                     args["tf_lut"], density, **kw)
    loss = torch.sum(img ** 2)
    grads = torch.autograd.grad(loss, leaves)
    return (float(jval), [np.asarray(g, np.float32) for g in jgrads],
            float(loss.detach()), [g.float().numpy() for g in grads], grads)


def _close(got, ref, bf16=False):
    """Max error within 5e-4 of the reference's largest magnitude (the JAX
    suite's bound between routes, tests/test_hist_decode.py:310-315); a bf16
    cotangent may also differ by one rounding of its storage dtype."""
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, atol=5e-4 * scale,
                               rtol=BF16_ULP if bf16 else 0.0)


CASES = list(itertools.product(["linear", "var", "entropy"],
                               ["inkernel", "materialized"],
                               ["float32", "bfloat16"]))


@pytest.mark.parametrize("stat,route,dtype", CASES)
def test_hist_render_diff_matches_jax(stat, route, dtype):
    bf16 = dtype == "bfloat16"
    h = _hist(seed=3, dtype=getattr(jnp, dtype))
    # JAX's in-kernel variance chain stores its moments in the storage
    # dtype (slice_vjp.py:780), a bf16 rounding of m and 2(mC0 - C1) that
    # the port's float32 moments do not make: hold that case to JAX's
    # materialized route, whose moments are float32 (the routes agree)
    jax_route = "materialized" if (stat, bf16) == ("var", True) else route
    jval, jg, val, g, tg = _both(h, stat, route, ("hist", "lut"),
                                 argnums=(0, 2), jax_route=jax_route)
    assert abs(jval) > 1.0, "vacuous comparison: image is black"
    assert abs(val - jval) / abs(jval) < 1e-5
    assert tg[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(g[0], jg[0], bf16)  # d_hist
    _close(g[1], jg[1])        # d_lut


@pytest.mark.parametrize("wrt", [("lut",), ("hist",),
                                 ("hist", "weights", "lut", "params")])
def test_wrt_subsets_match_jax(wrt):
    """Listed inputs match JAX; unlisted ones get exact zeros on both."""
    h = _hist(seed=5)
    jval, jg, val, g, _ = _both(h, "linear", "inkernel", wrt)
    assert abs(val - jval) / abs(jval) < 1e-5
    for name, got, ref in zip(("hist", "weights", "lut"), g, jg):
        if name in wrt:
            _close(got, ref)
        else:
            assert np.abs(ref).max() == 0.0 and np.abs(got).max() == 0.0


@pytest.mark.parametrize("route", ["inkernel", "materialized"])
def test_saturating_density_matches_jax(route):
    """Density 5: most rays freeze within a few planes, so the backward's
    replayed freeze masks decide most of the gradient."""
    h = _hist(seed=7)
    jval, jg, val, g, _ = _both(h, "linear", route, ("hist", "lut"),
                                density=5.0, argnums=(0, 2))
    assert abs(val - jval) / abs(jval) < 1e-5
    _close(g[0], jg[0])
    _close(g[1], jg[1])


@pytest.mark.parametrize("route", ["inkernel", "materialized"])
def test_entropy_zero_bin_gradient_is_exactly_zero(route):
    rng = np.random.default_rng(23)
    h = rng.random((8, 8, 8, 8)).astype(np.float32)
    h[:, 3] = 0.0  # a bin that is exactly zero everywhere
    h /= h.sum(axis=1, keepdims=True)
    rows, mode = _rows("entropy")
    hist = torch.tensor(h, requires_grad=True)
    img = tv.pallas_hist_render_diff(hist, rows, O, TF, 0.3, width=32,
                                     height=24, wrt=("hist",), stat=mode,
                                     route=route)
    (g,) = torch.autograd.grad(torch.sum(img ** 2), [hist])
    assert bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0.0
    assert float(g[:, 3].abs().max()) == 0.0, "zero bins get zero cotangent"


@pytest.mark.parametrize("stat", ["linear", "entropy"])
def test_auto_route_matches_jax(stat):
    """route='auto' picks JAX's route: its value equals JAX's auto value."""
    h = _hist(seed=11)
    rows, mode = _rows(stat)

    def jloss(hh):
        return jnp.sum(jv.pallas_hist_render_diff(
            hh, jnp.asarray(rows), jnp.asarray(O), jnp.asarray(TF),
            width=W, height=H, wrt=("hist",), stat=mode, route="auto") ** 2)

    with pltpu.force_tpu_interpret_mode():
        jval = float(jloss(jnp.asarray(h)))
    hist = torch.tensor(h, requires_grad=True)
    val = float(torch.sum(tv.pallas_hist_render_diff(
        hist, rows, O, TF, width=W, height=H, wrt=("hist",), stat=mode,
        route="auto") ** 2).detach())
    assert abs(val - jval) / abs(jval) < 1e-5
    want = "inkernel" if stat == "entropy" else "materialized"
    assert tv.auto_route(hist.shape, hist.dtype, mode) == want
