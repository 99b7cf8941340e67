"""Port parity of the distribution-native distributed sweep
(``vrdd_tpu_torch/parallel/sweep.py``: ``distributed_hist_render`` and
``distributed_shearwarp_hist_render``) against ``vrdd_tpu.parallel.sweep``.

JAX's histogram paths are Pallas-only: they run here under the TPU
interpreter on the conftest's virtual CPU mesh, once per input (module
fixtures), at test_dist_hist.py's sizes (16^3 x 8 -> 128^2; 8^3 x 4 -> 16^2
rotated). The port runs the same numpy inputs through its shards in one
process on the CPU, where the sweep kernels take their plain versions, at
several ``(bricks, rays)``. Gradients are held against JAX's single-device
XLA sweep of the materialized decode (JAX's interpreter gradient costs ~25 s
a case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.march.slice import slice_render_image as j_slice_render
from vrdd_tpu.pallas.slice_kernel import decode_weight_rows, decode_with_rows
from vrdd_tpu.parallel import mesh as jmesh
from vrdd_tpu.parallel import sweep as jsweep
from vrdd_tpu_torch.io.synthetic import blob_histogram_volume
from vrdd_tpu_torch.march.shearwarp import shearwarp_geometry
from vrdd_tpu_torch.parallel import sweep as tsweep
from vrdd_tpu_torch.parallel.mesh import make_mesh

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
W = H = 128
#: phase 8c's views: principal axes z, x and y, d_z of both signs
VIEWS = ((30.0, 20.0), (0.0, 60.0), (60.0, 0.0))
MESHES = [(1, 1), (2, 1), (4, 2), (2, 2), (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(nz=16, B=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.random((nz, B, nz, nz)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    return h, ((np.arange(B, dtype=np.float32) + 0.5) / B)


def _mesh(bricks, rays):
    return make_mesh(bricks, rays, devices=["cpu"])


def _jax_mesh(bricks):
    return jmesh.make_mesh(bricks, 1, devices=jax.devices()[:bricks])


def _flips(got, ref, tol=1e-4, share=1e-3):
    """Saturating cases: within ``tol`` on all but ``share`` of pixels."""
    bad = np.abs(got - ref).max(-1) > tol
    assert bad.mean() <= share, (bad.mean(), np.abs(got - ref).max())


@pytest.fixture(scope="module")
def jax_unrotated():
    """JAX's distributed hist render on 2 bricks: (seed 3, density 0.05)
    and the saturating (seed 7, density 5.0)."""
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for seed, density in ((3, 0.05), (7, 5.0)):
            h, w = _hist(seed=seed)
            out[density] = (h, w, np.asarray(jsweep.distributed_hist_render(
                jsweep.shard_hist_volume(jnp.asarray(h), _jax_mesh(2)),
                jnp.asarray(w), jnp.asarray(O), jnp.asarray(TF),
                density=density, width=W, height=H, mesh=_jax_mesh(2))))
    return out


@pytest.mark.parametrize("bricks,rays", MESHES)
def test_distributed_hist_matches_jax(jax_unrotated, bricks, rays):
    h, w, ref = jax_unrotated[0.05]
    mesh = _mesh(bricks, rays)
    got = tsweep.distributed_hist_render(
        tsweep.shard_hist_volume(h, mesh), w, O, TF, width=W, height=H,
        mesh=mesh).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("bricks,rays", [(2, 1), (4, 2), (4, 1)])
def test_distributed_hist_early_termination_exact(jax_unrotated, bricks,
                                                  rays):
    """Saturating density: the first-crossing slab and the seeded pass 2
    (every other pixel frozen at alpha 2) against JAX's two passes and the
    sequential single-device sweep."""
    h, w, ref = jax_unrotated[5.0]
    assert (ref[..., 3] > 0.95).any()  # the cutoff is reached
    got = tsweep.distributed_hist_render(
        torch.from_numpy(h), w, O, TF, density=5.0, width=W, height=H,
        mesh=_mesh(bricks, rays)).numpy()
    _flips(got, ref)
    one = tsweep.distributed_hist_render(
        torch.from_numpy(h), w, O, TF, density=5.0, width=W, height=H,
        mesh=_mesh(1, 1)).numpy()
    _flips(got, one)


def test_distributed_hist_var_stat():
    """A nonlinear statistic decoded per brick, against JAX's materialized
    single-device render."""
    h, _ = _hist(seed=13)
    rows, mode = decode_weight_rows("var", 8, family="unit")
    dec = decode_with_rows(jnp.asarray(h), rows, mode)
    ref = np.asarray(j_slice_render(
        dec, jnp.asarray(O), W, H, jnp.asarray(TF), n_planes=16, density=0.6,
        transfer_scale=8.0, use_custom_vjp=False))
    got = tsweep.distributed_hist_render(
        torch.from_numpy(h), np.asarray(rows), O, TF, density=0.6,
        transfer_scale=8.0, width=W, height=H, mesh=_mesh(2, 2),
        stat=mode).numpy()
    assert np.abs(ref).max() > 1e-3, "vacuous comparison: image is black"
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_grads():
    """Smooth histograms and JAX's single-device gradients (hist, LUT,
    density) of sum(img^2) through the materialized decode, per density:
    one compile serves both."""
    h = blob_histogram_volume(16, 8, device="cpu",
                              dtype=torch.float32).numpy()
    w = (np.arange(8, dtype=np.float32) + 0.5) / 8

    def jloss(hh, lut, d):
        dec = jnp.einsum("zbyx,b->zyx", hh, jnp.asarray(w))
        img = j_slice_render(dec, jnp.asarray(O), W, H, lut, n_planes=16,
                             density=d, use_custom_vjp=False)
        return jnp.sum(img ** 2)

    grad = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))
    return h, w, {d: grad(jnp.asarray(h), jnp.asarray(TF), jnp.float32(d))
                  for d in (0.01, 0.05)}


@pytest.mark.parametrize("bricks,rays,density", [(2, 1, 0.01), (4, 2, 0.01),
                                                 (4, 2, 0.05)])
def test_distributed_hist_gradients(jax_grads, bricks, rays, density):
    """Histogram, LUT and density cotangents through the shards: per-slab
    K4/K5 plain versions, the pass-2 seed cotangent into upstream bricks
    and the LUT's sum over the mesh, against JAX's single-device autodiff
    of the materialized decode (smooth histograms; at density 0.05 18% of
    the rays reach the cutoff, at 0.01 none)."""
    h, w, refs = jax_grads
    ht = torch.tensor(h, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    dt = torch.tensor(density, requires_grad=True)
    img = tsweep.distributed_hist_render(
        ht, w, O, lt, dt, width=W, height=H, mesh=_mesh(bricks, rays),
        wrt=("hist", "lut", "params"))
    (img ** 2).sum().backward()
    assert (float(img.detach()[..., 3].max()) > 0.95) == (density > 0.02)
    for name, got, ref in zip(("hist", "lut", "density"),
                              (ht.grad, lt.grad, dt.grad), refs[density]):
        assert _rel_l2(got.numpy(), ref) < 1e-3, name


@pytest.fixture(scope="module")
def jax_rotated():
    """JAX's rotated distribution-native render of each view on a 1 x 1
    mesh (the CLI's call, at the default oversample)."""
    h, w = _hist(nz=8, B=4, seed=17)
    out = []
    with pltpu.force_tpu_interpret_mode():
        for rx, ry in VIEWS:
            iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
            out.append(np.asarray(jsweep.distributed_shearwarp_hist_render(
                jnp.asarray(h), jnp.asarray(w), iv, 16, 16, jnp.asarray(TF),
                mesh=_jax_mesh(1), density=0.6)))
    return h, w, out


@pytest.mark.parametrize("bricks,rays", [(1, 1), (2, 1), (2, 2)])
def test_distributed_shearwarp_hist_matches_jax(jax_rotated, bricks, rays):
    """Rotated views, in-kernel decode, sharded: JAX's m-grid (128-rounded
    columns, rows extended to rays x STRIP), the permuted slab shards and
    the warp, for the three principal axes and both d_z signs; and tight
    against the scalar distributed path on the materialized decode (same
    m-grid, only the decode moves)."""
    h, w, refs = jax_rotated
    dec = torch.from_numpy(np.einsum("zbyx,b->zyx", h, w))
    mesh = _mesh(bricks, rays)
    signs, axes = set(), set()
    for (rx, ry), ref in zip(VIEWS, refs):
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        axis, _, _, dz_sign, ok = shearwarp_geometry(iv, 16, 16)
        signs.add(dz_sign)
        axes.add(axis)
        got = tsweep.distributed_shearwarp_hist_render(
            torch.from_numpy(h), w, iv, 16, 16, TF, mesh=mesh,
            density=0.6).numpy()
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0,
                                   err_msg=f"view {rx, ry}")
        scalar = tsweep.distributed_shearwarp_render(
            dec, iv, 16, 16, TF, density=0.6, mesh=mesh, n_planes=8,
            backend="pallas", plane_chunk=4).numpy()
        np.testing.assert_allclose(got, scalar, atol=2e-5, rtol=0)
    assert signs == {-1, 1} and axes == {0, 1, 2}


def test_distributed_shearwarp_hist_gradients():
    """Histogram + LUT cotangents through the permutation, the slab shards,
    the seeded pass 2 and the warp, against ``jax.grad`` of JAX's
    ``distributed_shearwarp_hist_render`` (its Pallas kernels in the TPU
    interpreter, on one device: the two-pass termination is exact, so the
    mesh does not change the function), and against the scalar
    distributed path on the materialized decode (torch autograd through the
    decode)."""
    h = blob_histogram_volume(8, 4, device="cpu",
                              dtype=torch.float32).numpy()
    w = (np.arange(4, dtype=np.float32) + 0.5) / 4
    iv = inv_view_from_rotation_translation(70.0, 15.0, (0.0, 0.0, -4.0))
    mesh = _mesh(2, 1)
    ht = torch.tensor(h, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    img = tsweep.distributed_shearwarp_hist_render(
        ht, w, iv, 16, 16, lt, mesh=mesh, density=3.0, wrt=("hist", "lut"))
    (img ** 2).sum().backward()
    assert float(img.detach()[..., 3].max()) > 0.95  # the cutoff is reached

    def jloss(hh, lut):
        return jnp.sum(jsweep.distributed_shearwarp_hist_render(
            hh, jnp.asarray(w), iv, 16, 16, lut, density=3.0,
            mesh=_jax_mesh(1), wrt=("hist", "lut")) ** 2)

    with pltpu.force_tpu_interpret_mode():
        jh, jl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                                 jnp.asarray(TF))
    assert _rel_l2(ht.grad, jh) < 1e-3
    assert _rel_l2(lt.grad, jl) < 1e-3

    hs = torch.tensor(h, requires_grad=True)
    ls = torch.tensor(TF, requires_grad=True)
    dec = torch.einsum("zbyx,b->zyx", hs, torch.from_numpy(w))
    ref = tsweep.distributed_shearwarp_render(
        dec, iv, 16, 16, ls, density=3.0, mesh=mesh, n_planes=8,
        backend="pallas", plane_chunk=4, wrt=("volume", "lut"))
    (ref ** 2).sum().backward()
    assert _rel_l2(ht.grad, hs.grad) < 1e-3
    assert _rel_l2(lt.grad, ls.grad) < 1e-3


def test_shearwarp_hist_supported_uses_permuted_shape():
    """The rotated path's support check (the CLI's gate on the card) reads
    the PERMUTED volume: a y-principal view of a volume whose y extent does
    not divide over the bricks fails while a z-principal one passes; an
    oversized LUT fails (shared memory)."""
    iv_z = inv_view_from_rotation_translation(10.0, 15.0, (0.0, 0.0, -4.0))
    iv_y = inv_view_from_rotation_translation(80.0, 5.0, (0.0, 0.0, -4.0))
    assert shearwarp_geometry(iv_y, 64, 64)[0] == 1
    shape = (64, 16, 30, 64)
    mesh = _mesh(4, 2)
    assert tsweep.shearwarp_hist_supported(shape, iv_z, 256, 256, mesh=mesh)
    assert not tsweep.shearwarp_hist_supported(shape, iv_y, 256, 256,
                                               mesh=mesh)
    assert tsweep.shearwarp_hist_supported(shape, iv_y, 256, 256)
    assert not tsweep.shearwarp_hist_supported(shape, iv_z, 256, 256,
                                               n_lut=4096)


def test_octant_cache_slots_and_clear():
    """One cache slot per entry point: alternating scalar and hist permutes
    keep both, a source that requires grad bypasses the cache, and
    clear_octant_cache drops the pinned tensors."""
    tsweep.clear_octant_cache()
    mesh = _mesh(1, 1)
    vol = torch.arange(8.0).reshape(2, 2, 2)
    hist = torch.arange(16.0).reshape(2, 2, 2, 2)
    a1 = tsweep._permuted_sharded(vol, (2, 1, 0), mesh, slot="scalar")
    b1 = tsweep._permuted_sharded(hist, (0, 1, 3, 2), mesh, slot="hist")
    a2 = tsweep._permuted_sharded(vol, (2, 1, 0), mesh, slot="scalar")
    b2 = tsweep._permuted_sharded(hist, (0, 1, 3, 2), mesh, slot="hist")
    assert a2 is a1 and b2 is b1
    assert torch.equal(a1, vol.permute(2, 1, 0))
    leaf = vol.clone().requires_grad_(True)
    assert tsweep._permuted_sharded(leaf, (2, 1, 0), mesh).grad_fn is not None
    tsweep.clear_octant_cache("scalar")
    assert "scalar" not in tsweep._OCTANT_CACHE
    assert "hist" in tsweep._OCTANT_CACHE
    tsweep.clear_octant_cache()
    assert not tsweep._OCTANT_CACHE
