"""Port parity of ``fit-voxels`` (BASELINE.json config 3, per-voxel Gaussian
(mu, sigma) fitted to multi-view renders): the port's loss and gradients
at one set of parameters against JAX's, on the CPU, with and without the
streamed decode.

``vrdd_tpu.cli.cmd_fit_voxels`` builds its loss inside the command, so the
JAX side here is that body's problem rebuilt from vrdd_tpu's own functions
(the renderer JAX picks off the TPU: the plain sweep for the unrotated
view, shear-warp's 'xla' backend for the rotated ones, the streamed decode's
'xla' backend). The port's side is ``cli.fit_voxels_problem``, started from
the same parameters through ``convert.fit_voxels_state_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu.core.transfer import grayscale_ramp
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.shearwarp import shearwarp_render_image
from vrdd_tpu.march.slice import slice_render_image
from vrdd_tpu.march.streaming import streaming_decode_render
from vrdd_tpu.ops.gaussian import gaussian_stats
from vrdd_tpu_torch import cli as tcli
from vrdd_tpu_torch.convert import fit_voxels_state_from_jax

N, IMG, VIEWS, ANGLE, SEED = 8, 16, 3, 25.0, 0

#: the parity cases beyond the 25-degree views (which all sweep along z
#: with d_z -1): five views at 60 degrees sweep along z, y and x, along y
#: and x in both directions. (renderer, n, image): the plain sweeps and
#: shear-warp's 'xla' m-grid; the fused path's plain versions at 64^2,
#: where oversample 2 makes the 128-rounded m-grid JAX's own 128.
ROTATED = {"xla-60deg-5views": ("auto", N, IMG),
           "pallas-60deg-5views": ("pallas", 16, 64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one thread: the suite runs several test processes
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_losses(mu, log_sigma, views=VIEWS, angle=ANGLE, W=IMG,
                streamed_too=True):
    """JAX's fit-voxels loss (vrdd_tpu/cli.py:333-403) and its gradients at
    ``(mu, log_sigma)`` for ``views`` at ``angle`` degrees and ``W``-square
    images, unstreamed and (``streamed_too``) streamed, in one compiled
    call."""
    n = mu.shape[0]
    mu_true = jnp.asarray(gaussian_blob_volume((n, n, n), seed=SEED))
    sigma_true = 0.05 + 0.15 * jnp.asarray(
        gaussian_blob_volume((n, n, n), seed=SEED + 1))
    lut = jnp.asarray(grayscale_ramp(9))
    views = [(0.0, 0.0), (angle, 0.0), (0.0, angle), (-angle, 0.0),
             (0.0, -angle)][:views]
    var_scale = 1.0 / float(jnp.max(sigma_true) ** 2)
    origin = jnp.asarray([0.0, 0.0, 4.0])

    def render_channel(vol, rx, ry, tf_scale):
        if (rx, ry) == (0.0, 0.0):
            return slice_render_image(vol, origin, W, W, lut,
                                      transfer_scale=tf_scale, n_planes=2 * n)
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        return shearwarp_render_image(vol, iv, W, W, lut,
                                      transfer_scale=tf_scale, n_planes=2 * n,
                                      backend="xla", wrt=("volume",))

    def render_views(mu_, log_sigma_, streamed):
        stats = gaussian_stats(mu_, jnp.exp(log_sigma_))
        out = []
        for rx, ry in views:
            if streamed and (rx, ry) == (0.0, 0.0):
                out.append(tuple(streaming_decode_render(
                    (mu_, log_sigma_),
                    lambda t, ch=ch: gaussian_stats(t[0], jnp.exp(t[1]))[
                        ..., ch],
                    origin, lut, transfer_scale=s, width=W, height=W,
                    n_planes=2 * n, wrt=("volume",), backend="xla")
                    for ch, s in ((0, 1.0), (1, var_scale))))
            else:
                out.append((render_channel(stats[..., 0], rx, ry, 1.0),
                            render_channel(stats[..., 1], rx, ry, var_scale)))
        return out

    def loss_fn(params, streamed):
        targets = jax.lax.stop_gradient(
            render_views(mu_true, jnp.log(sigma_true), streamed))
        loss = 0.0
        for (rm, rv), (tm, tv) in zip(render_views(*params, streamed),
                                      targets):
            loss = loss + jnp.mean((rm - tm) ** 2) + jnp.mean((rv - tv) ** 2)
        return loss / len(views)

    @jax.jit
    def both(params):
        return [jax.value_and_grad(loss_fn)(params, s)
                for s in ((False, True) if streamed_too else (False,))]

    return both((jnp.asarray(mu), jnp.asarray(log_sigma)))


def _state(n):
    """A fit-voxels state away from the start, as a JAX checkpoint holds it:
    the (mu, sigma) numpy pair."""
    rng = np.random.default_rng(3)
    mu = (0.6 * rng.random((n, n, n))).astype(np.float32)
    sigma = (0.05 + 0.15 * rng.random((n, n, n))).astype(np.float32)
    return mu, sigma


@pytest.fixture(scope="module")
def params():
    return _state(N)


@pytest.fixture(scope="module")
def jax_ref(params):
    mu, sigma = params
    out = _jax_losses(mu, np.log(sigma).astype(np.float32))
    return [(float(v), [np.asarray(x) for x in g]) for v, g in out]


@pytest.mark.parametrize("case", [False, True, *ROTATED],
                         ids=["False", "True", *ROTATED])
def test_loss_and_gradients_match_jax(params, jax_ref, case):
    """The port's fit-voxels loss (plain sweeps on the CPU; a rotated case
    on its renderer) and its gradients to (mu, log sigma) against JAX's
    (plain sweeps, shear-warp's 'xla' backend) at the same parameters: loss
    1e-5 relative, gradients 1e-5 relative L2. ``case`` is the 25-degree
    views unstreamed or streamed, or a :data:`ROTATED` case."""
    renderer, n, img = ROTATED.get(case, ("auto", N, IMG))
    views, angle, streamed = ((5, 60.0, False) if case in ROTATED
                              else (VIEWS, ANGLE, case))
    loss_fn, mu_true, used = tcli.fit_voxels_problem(
        n, img, views, angle, SEED, renderer, streamed, torch.device("cpu"))
    assert used == ("slice" if renderer == "auto" else renderer)
    assert tuple(mu_true.shape) == (n, n, n)
    state = params if n == N else _state(n)
    mu, log_sigma = fit_voxels_state_from_jax(*state, "cpu")
    mu.requires_grad_()
    log_sigma.requires_grad_()
    loss = loss_fn(mu, log_sigma)
    grads = torch.autograd.grad(loss, [mu, log_sigma])
    if case in ROTATED:
        out = _jax_losses(state[0], np.log(state[1]).astype(np.float32),
                          views=views, angle=angle, W=img,
                          streamed_too=False)
        ref_loss, ref_grads = float(out[0][0]), [np.asarray(g)
                                                 for g in out[0][1]]
    else:
        ref_loss, ref_grads = jax_ref[streamed]
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    for g, r in zip(grads, ref_grads):
        rel = float(np.linalg.norm(g.numpy() - r) / np.linalg.norm(r))
        assert rel <= 1e-5, rel


def test_fused_renderer_on_the_cpu(params):
    """renderer 'pallas' on the CPU runs the fused path's plain versions
    (K3/K4/K5, shear-warp on the 128-rounded m-grid, the seeded streamed
    chunks) with no kernel launch and finite gradients; streaming changes
    its loss by at most 1e-5 relative; on the unrotated view alone it is
    the plain sweep's loss (1e-5) and gradients (1e-4 relative L2)."""
    from vrdd_tpu_torch.kernels import slice_vjp as tv

    counters = (tv.sweep_fwd, tv.sweep_fwd_ckpt, tv.sweep_bwd)
    mu, log_sigma = fit_voxels_state_from_jax(*params, "cpu")

    def run(renderer, streamed, views):
        loss_fn, _, used = tcli.fit_voxels_problem(
            N, IMG, views, ANGLE, SEED, renderer, streamed,
            torch.device("cpu"))
        assert used == renderer
        p = [mu.clone().requires_grad_(), log_sigma.clone().requires_grad_()]
        before = [f.launches for f in counters]
        loss = loss_fn(*p)
        grads = torch.autograd.grad(loss, p)
        assert [f.launches for f in counters] == before
        assert all(torch.isfinite(g).all() for g in grads)
        return float(loss.detach()), grads

    full, streamed = run("pallas", False, VIEWS), run("pallas", True, VIEWS)
    assert abs(streamed[0] - full[0]) <= 1e-5 * full[0]
    one, one_ref = run("pallas", False, 1), run("slice", False, 1)
    assert abs(one[0] - one_ref[0]) <= 1e-5 * one_ref[0]
    for g, r in zip(one[1], one_ref[1]):
        assert float((g - r).norm() / r.norm()) <= 1e-4


def test_state_from_jax_round_trip(params):
    mu, sigma = params
    t_mu, t_ls = fit_voxels_state_from_jax(mu, sigma, "cpu")
    assert t_mu.dtype == t_ls.dtype == torch.float32
    np.testing.assert_array_equal(t_mu.numpy(), mu)
    np.testing.assert_allclose(torch.exp(t_ls).numpy(), sigma, rtol=1e-6)
    np.testing.assert_allclose(t_ls.numpy(), np.log(sigma), rtol=1e-6)


def test_device_blob_matches_numpy():
    """fit-voxels' ground truth made on a device (as on the card at 256^3)
    is the numpy blob from the same seed, to float32 rounding."""
    from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume as blob

    for seed in (0, 1):
        ref = blob((12, 10, 14), seed=seed)
        got = blob((12, 10, 14), seed=seed, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
