"""Distributed differentiable TF-LUT fitting (counterpart of
``vrdd_tpu/parallel/train.py``).

Fit the transfer-function LUT (and optionally the volume) so rendered images
match targets, through the distributed renderers of this package: gradients
flow back through the mesh's collectives (``parallel/mesh.py``) and the
LUT's gradient is summed over the mesh. Each process renders its rows; the
loss is JAX's mean over the whole image, formed from them
(:func:`~.mesh.image_mean`), so every process steps with the one-process
loss and gradients. ``torch.optim.Adam`` (lr 1e-2,
betas 0.9 / 0.999, eps 1e-8) stands where JAX has ``optax.adam(1e-2)``.

Both factories return JAX's ``(init_fn, step_fn)``: ``init_fn`` makes the
parameter dict (leaf tensors on the mesh's device) and the optimizer, which
holds its state; ``step_fn`` takes one step in place and returns ``(params,
opt_state, loss)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vrdd_tpu_torch.parallel.bricks import distributed_render_image
from vrdd_tpu_torch.parallel.mesh import Mesh, image_mean, local_rows
from vrdd_tpu_torch.utils.config import MarchConfig

#: ``params -> torch.optim.Optimizer`` (JAX's ``optax.GradientTransformation``)
OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def _adam(params: list) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


def _factories(loss_fn, mesh: Mesh, optimizer: Optional[OptimizerFactory],
               learned: str, learn_volume: bool):
    optimizer = _adam if optimizer is None else optimizer

    def init_fn(tf_lut, volume=None):
        params = {"tf_lut": tf_lut}
        if learn_volume:
            params[learned] = volume
        params = {k: torch.as_tensor(v, dtype=torch.float32).detach().clone()
                  .to(mesh.device).requires_grad_(True)
                  for k, v in params.items()}
        return params, optimizer(list(params.values()))

    def step_fn(params, opt_state, volume, camera, target):
        opt_state.zero_grad()
        loss = loss_fn(params, volume, camera, target)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init_fn, step_fn


def make_tf_fit_step(
    mesh: Mesh,
    width: int,
    height: int,
    channel: int = 0,
    march: MarchConfig = MarchConfig(),
    optimizer: Optional[OptimizerFactory] = None,
    learn_volume: bool = False,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for distributed TF fitting through the scan
    marcher on bricks (:func:`~.bricks.distributed_render_image`; any
    camera). ``step_fn(params, opt_state, stats, inv_view, target) ->
    (params, opt_state, loss)`` with ``params = {"tf_lut"}`` (plus
    ``"stats"`` when ``learn_volume``); ``init_fn(tf_lut, stats)``. For
    unrotated cameras over a scalar field :func:`make_sweep_fit_step` runs
    the fused sweep kernels instead."""

    def loss_fn(params, stats, inv_view, target):
        if learn_volume:
            stats = params["stats"]
        img = distributed_render_image(
            stats, inv_view, params["tf_lut"], 0.05, 1.0, 0.0, 1.0,
            width=width, height=height, channel=channel, march=march,
            mesh=mesh)
        return image_mean((img - target) ** 2, mesh)

    return _factories(loss_fn, mesh, optimizer, "stats", learn_volume)


def shard_target_image(target, mesh: Mesh) -> torch.Tensor:
    """This process's rows of an ``(H, W, 4)`` target image (its ray
    strips in ascending order, JAX's ``P(RAY_AXIS)``), on the mesh's
    device."""
    target = torch.as_tensor(target, dtype=torch.float32)
    return local_rows(target, mesh).to(mesh.device)


def make_sweep_fit_step(
    mesh: Mesh,
    width: int,
    height: int,
    march: MarchConfig = MarchConfig(),
    optimizer: Optional[OptimizerFactory] = None,
    learn_volume: bool = False,
    n_planes: int = 0,
    backend: str = "auto",
    plane_chunk: int = 4,
    density: float = 0.05,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for distributed fitting on the sweep
    (:func:`~.sweep.distributed_sweep_render`: the K4/K5 kernels per shard on
    the card, the plain sweep or the kernels' plain versions on the CPU).
    ``wrt`` is derived from ``learn_volume``, so the kernels' backward
    prunes the cotangents nothing trains.

    ``step_fn(params, opt_state, volume, origin, target) -> (params,
    opt_state, loss)`` with ``params = {"tf_lut"}`` (plus ``"volume"`` when
    ``learn_volume``); ``volume`` from :func:`~.sweep.shard_scalar_volume`,
    ``target`` from :func:`shard_target_image`; ``init_fn(tf_lut,
    volume=None)``."""
    from vrdd_tpu_torch.parallel.sweep import distributed_sweep_render

    wrt = ("volume", "lut", "params") if learn_volume else ("lut", "params")

    def loss_fn(params, volume, origin, target):
        if learn_volume:
            volume = params["volume"]
        img = distributed_sweep_render(
            volume, origin, params["tf_lut"], density, width=width,
            height=height, march=march, mesh=mesh, n_planes=n_planes,
            backend=backend, plane_chunk=plane_chunk, wrt=wrt)
        return image_mean((img - target) ** 2, mesh)

    return _factories(loss_fn, mesh, optimizer, "volume", learn_volume)
