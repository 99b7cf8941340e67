"""Port parity of the distributed scalar sweep
(``vrdd_tpu_torch/parallel/sweep.py``: ``distributed_sweep_render``,
``distributed_sweep_slope_space``, ``distributed_shearwarp_render``)
against ``vrdd_tpu.parallel.sweep`` on the conftest's virtual CPU mesh.

JAX runs its ``backend='xla'`` sweep; the port runs both of its backends on
the CPU: 'xla' (the plain torch sweep, two-pass termination by the local
threshold) and 'pallas' (the sweep kernels' plain versions, pass 2 seeded),
with the same ``(bricks, rays)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu.core.transfer import default_transfer_function
from vrdd_tpu.io.synthetic import gaussian_blob_volume
from vrdd_tpu.march.shearwarp import _warp_from_rotation_traced as j_warp
from vrdd_tpu.march.shearwarp import shearwarp_render_image as j_shearwarp
from vrdd_tpu.parallel import mesh as jmesh
from vrdd_tpu.parallel import sweep as jsweep
from vrdd_tpu.utils.config import MarchConfig as JMarchConfig
from vrdd_tpu_torch.kernels.slice_kernel import _slope_grids
from vrdd_tpu_torch.march.shearwarp import shearwarp_geometry
from vrdd_tpu_torch.parallel import sweep as tsweep
from vrdd_tpu_torch.parallel.mesh import make_mesh
from vrdd_tpu_torch.utils.config import MarchConfig

TF = default_transfer_function()
O = np.array([0.0, 0.0, 4.0], np.float32)
VIEWS = ((30.0, 20.0), (0.0, 60.0), (60.0, 0.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's small torch ops on one thread: the suite runs
    several test processes side by side, and intra-op threads only add
    contention at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(bricks, rays):
    return make_mesh(bricks, rays, devices=["cpu"])


def _chunk(backend):
    return 4 if backend == "pallas" else 8


def _jax_render(vol, bricks, rays, **kw):
    m = jmesh.make_mesh(bricks, rays)
    return np.asarray(jsweep.distributed_sweep_render(
        jsweep.shard_scalar_volume(jnp.asarray(vol), m), jnp.asarray(O),
        jnp.asarray(TF), mesh=m, backend="xla", **kw))


def _flips(got, ref, tol=1e-4, share=1e-3):
    bad = np.abs(got - ref).max(-1) > tol
    assert bad.mean() <= share, (bad.mean(), np.abs(got - ref).max())


@pytest.fixture(scope="module")
def jax_sweeps():
    """JAX's distributed renders on bricks=4 x rays=2 (its images agree
    across meshes to float32 rounding, tests/test_dist_sweep.py)."""
    vol = gaussian_blob_volume((16, 16, 16), seed=5)
    return vol, {n: _jax_render(vol, 4, 2, width=32, height=32, n_planes=n)
                 for n in (32, 16)}


@pytest.mark.parametrize("bricks,rays", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_distributed_sweep_matches_jax(jax_sweeps, bricks, rays):
    """n_planes = 2 nz pre-blends across the halo; n_planes = nz is the pure
    selection (slabs streamed on the 'pallas' backend)."""
    vol, refs = jax_sweeps
    for n_planes, ref in refs.items():
        for backend in ("xla", "pallas"):
            mesh = _mesh(bricks, rays)
            got = tsweep.distributed_sweep_render(
                tsweep.shard_scalar_volume(vol, mesh), O, TF, width=32,
                height=32, mesh=mesh, n_planes=n_planes, backend=backend,
                plane_chunk=_chunk(backend)).numpy()
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0,
                                       err_msg=f"{backend} {n_planes}")


def test_distributed_sweep_early_termination_exact():
    vol = gaussian_blob_volume((16, 16, 16), seed=2)
    ref = _jax_render(vol, 4, 2, density=5.0, width=32, height=32,
                      n_planes=32)
    assert (ref[..., 3] > 0.95).any()  # the cutoff is reached
    for backend in ("xla", "pallas"):
        got = tsweep.distributed_sweep_render(
            torch.from_numpy(vol), O, TF, density=5.0, width=32, height=32,
            mesh=_mesh(4, 2), n_planes=32, backend=backend,
            plane_chunk=_chunk(backend)).numpy()
        _flips(got, ref)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_sweep_grads():
    vol = gaussian_blob_volume((8, 8, 8), seed=1)
    m = jmesh.make_mesh(4, 2)

    def loss(v, lut, d):
        img = jsweep.distributed_sweep_render(
            v, jnp.asarray(O), lut, d, width=16, height=16, mesh=m,
            n_planes=16, backend="xla")
        return jnp.sum(img ** 2)

    return vol, jax.grad(loss, argnums=(0, 1, 2))(
        jsweep.shard_scalar_volume(jnp.asarray(vol), m), jnp.asarray(TF),
        jnp.float32(0.05))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_distributed_sweep_gradients(jax_sweep_grads, backend):
    """Volume, LUT and density cotangents through the halo pre-blend, the
    gather, the fold and pass 2, against JAX's distributed gradients."""
    vol, refs = jax_sweep_grads
    vt = torch.tensor(vol, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    dt = torch.tensor(0.05, requires_grad=True)
    img = tsweep.distributed_sweep_render(
        vt, O, lt, dt, width=16, height=16, mesh=_mesh(4, 2), n_planes=16,
        backend=backend, plane_chunk=_chunk(backend))
    (img ** 2).sum().backward()
    for name, got, ref in zip(("volume", "lut", "density"),
                              (vt.grad, lt.grad, dt.grad), refs):
        assert _rel_l2(got.numpy(), ref) < 1e-3, name


def test_distributed_shearwarp_matches_jax():
    """Rotated views on the 'xla' backend: permute + split the volume over
    bricks, sweep the m-grid, warp; the three principal axes and both d_z
    signs, against JAX's distributed shear-warp."""
    vol = gaussian_blob_volume((16, 16, 16), seed=5)
    m = jmesh.make_mesh(2, 4)
    signs, axes = set(), set()
    for rx, ry in VIEWS:
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        axis, _, _, dz_sign, _ = shearwarp_geometry(iv, 32, 32)
        signs.add(dz_sign)
        axes.add(axis)
        ref = np.asarray(jsweep.distributed_shearwarp_render(
            jnp.asarray(vol), iv, 32, 32, jnp.asarray(TF), mesh=m,
            n_planes=32, backend="xla"))
        for bricks, rays in ((2, 4), (1, 1)):
            got = tsweep.distributed_shearwarp_render(
                torch.from_numpy(vol), iv, 32, 32, TF, mesh=_mesh(bricks, rays),
                n_planes=32, backend="xla").numpy()
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    assert signs == {-1, 1} and axes == {0, 1, 2}


def test_distributed_shearwarp_pallas_backend():
    """The 'pallas' backend's m-grid (JAX's: 128-rounded columns, rows
    extended to rays x STRIP): the same image on every mesh, and close to
    the 'xla' backend's finer grid (warp-filter level)."""
    vol = torch.from_numpy(gaussian_blob_volume((16, 16, 16), seed=5))
    for rx, ry in VIEWS:
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -4.0))
        imgs = [tsweep.distributed_shearwarp_render(
            vol, iv, 32, 32, TF, mesh=_mesh(b, r), n_planes=16,
            backend="pallas", plane_chunk=4).numpy()
            for b, r in ((1, 1), (2, 2))]
        np.testing.assert_allclose(imgs[1], imgs[0], atol=2e-5, rtol=0)
        xla = tsweep.distributed_shearwarp_render(
            vol, iv, 32, 32, TF, mesh=_mesh(2, 2), n_planes=16,
            backend="xla").numpy()
        assert np.quantile(np.abs(imgs[0] - xla), 0.9) < 5e-2


def test_distributed_shearwarp_pallas_matches_jax():
    """The 'pallas' backend's rotated frame, value and gradients (volume,
    LUT), against JAX's distributed 'xla' sweep driven on the slopes the
    kernels sample (per ray strip: its first slope and the float32 step to
    the next, JAX's per-shard slopes) and JAX's warp by the m-grid's
    spacing, on the same 2 x 2 mesh; at a density where pass 2 runs."""
    bricks, rays = 2, 2
    vol = gaussian_blob_volume((16, 16, 16), seed=5)
    iv = inv_view_from_rotation_translation(30.0, 20.0, (0.0, 0.0, -4.0))
    perm, dz_sign, march_p, origin_p, mx, my, mgrid = tsweep._rotated_frame(
        iv, 16, 16, 2.0, MarchConfig(), 2.0, True, rays * tsweep.STRIP)
    hl = my.shape[0] // rays
    grids = [_slope_grids(tsweep._strip_slopes(mx, my[r * hl:(r + 1) * hl]),
                          mx.shape[0], hl) for r in range(rays)]
    mx_k, my_k = grids[0][0], np.concatenate([g[1] for g in grids])
    px, py, pz = perm
    m = jmesh.make_mesh(bricks, rays, devices=jax.devices()[:bricks * rays])

    def jframe(v, lut):
        img_m = jsweep.distributed_sweep_slope_space(
            jnp.transpose(v, (2 - pz, 2 - py, 2 - px)), jnp.asarray(origin_p),
            mx_k, my_k, lut, 3.0, march=JMarchConfig(
                max_steps=march_p.max_steps, tstep=march_p.tstep,
                opacity_threshold=march_p.opacity_threshold,
                box_min=march_p.box_min, box_max=march_p.box_max),
            mesh=m, dz_sign=dz_sign, n_planes=16, backend="xla")
        return j_warp(img_m, jnp.asarray(iv[:, :3]),
                      jnp.asarray(mgrid, jnp.float32), 16, 16, 2.0, perm)

    (_, ref), refs = jax.value_and_grad(
        lambda v, lut: (jnp.sum(jframe(v, lut) ** 2), jframe(v, lut)),
        argnums=(0, 1), has_aux=True)(jnp.asarray(vol), jnp.asarray(TF))
    vt = torch.tensor(vol, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    img = tsweep.distributed_shearwarp_render(
        vt, iv, 16, 16, lt, 3.0, mesh=_mesh(bricks, rays), n_planes=16,
        backend="pallas", plane_chunk=4)
    assert float(np.asarray(ref)[..., 3].max()) > 0.95  # pass 2 runs
    _flips(img.detach().numpy(), np.asarray(ref), tol=2e-5)
    (img ** 2).sum().backward()
    assert _rel_l2(vt.grad.numpy(), refs[0]) < 1e-3
    assert _rel_l2(lt.grad.numpy(), refs[1]) < 1e-3


def test_distributed_shearwarp_gradients():
    vol = gaussian_blob_volume((8, 8, 8), seed=1)
    iv = inv_view_from_rotation_translation(25.0, 15.0, (0.0, 0.0, -4.0))

    def jloss(v, lut):
        return jnp.sum(j_shearwarp(v, iv, 16, 16, lut, n_planes=16,
                                   backend="xla") ** 2)

    refs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(TF))
    vt = torch.tensor(vol, requires_grad=True)
    lt = torch.tensor(TF, requires_grad=True)
    img = tsweep.distributed_shearwarp_render(
        vt, iv, 16, 16, lt, mesh=_mesh(4, 2), n_planes=16, backend="xla")
    (img ** 2).sum().backward()
    assert _rel_l2(vt.grad.numpy(), refs[0]) < 1e-3
    assert _rel_l2(lt.grad.numpy(), refs[1]) < 1e-3


def test_distributed_replicated_flex_axis_scale_matches_jax():
    """Flexible-block grids: volume_mode='replicated' (the plane schedule
    split over bricks), a grid whose extents do not divide over the bricks,
    value and gradients against JAX's distributed sweep."""
    rng = np.random.default_rng(7)
    nzb, nyb, nxb = 6, 9, 11
    padded = np.pad(rng.random((nzb, nyb, nxb), dtype=np.float32),
                    ((0, 1), (0, 1), (0, 1)))
    ascale = (nxb / (nxb + 1), nyb / (nyb + 1), nzb / (nzb + 1))
    m = jmesh.make_mesh(4, 2)

    def jloss(v, lut):
        img = jsweep.distributed_sweep_render(
            v, jnp.asarray(O), lut, width=16, height=16, mesh=m,
            n_planes=16, axis_scale=ascale, backend="xla")
        return jnp.sum(img ** 2), img

    (_, ref), refs = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(padded), jnp.asarray(TF))
    for backend in ("xla", "pallas"):
        vt = torch.tensor(padded, requires_grad=True)
        lt = torch.tensor(TF, requires_grad=True)
        img = tsweep.distributed_sweep_render(
            vt, O, lt, width=16, height=16, mesh=_mesh(4, 2), n_planes=16,
            axis_scale=ascale, backend=backend, plane_chunk=_chunk(backend))
        np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref),
                                   atol=2e-5, rtol=0)
        (img ** 2).sum().backward()
        assert _rel_l2(vt.grad.numpy(), refs[0]) < 1e-3, backend
        assert _rel_l2(lt.grad.numpy(), refs[1]) < 1e-3, backend


def test_slab_mode_refuses_a_scaled_grid():
    with pytest.raises(ValueError, match="replicated"):
        tsweep.distributed_sweep_render(
            torch.zeros((4, 4, 4)), O, TF, width=8, height=8,
            mesh=_mesh(2, 1), axis_scale=(1.0, 1.0, 0.8), volume_mode="slab")
    with pytest.raises(ValueError, match="divide"):
        tsweep.distributed_sweep_render(
            torch.zeros((6, 4, 4)), O, TF, width=8, height=8,
            mesh=_mesh(4, 1))
