"""The multi-view fit of a per-voxel Gaussian volume (BASELINE.json config 3,
the ``fit-voxels`` job of ``vrdd_tpu/cli.py`` cmd_fit_voxels).

The parameters are a per-voxel mean ``mu`` and ``log sigma``, each ``(n, n,
n)`` float32. A step decodes them (``ops/gaussian.py gaussian_stats``: the
mean channel ``mu`` and the variance channel ``sigma^2``), renders both
channels from every camera of the view list through the differentiable
renderer, takes the mean over views of the two channels' mean squared
errors against the targets (the same renders of the ground truth), and
backpropagates to ``(mu, log sigma)``.

The cameras (:func:`view_list`): (0, 0), then (+-``view_angle``, 0) and (0,
+-``view_angle``) degrees about x and y, up to five, each at distance 4 from
the centre. An unrotated view is the plain sweep along z; a rotated one
goes through shear-warp (``march/shearwarp.py``), whose principal axis may
be x, y or z and whose sweep may run either way along it. Renderer
'pallas' takes the fused kernels (K4 forward, K5 backward;
``pallas_slice_render_diff`` unrotated, shear-warp's 'pallas' backend
rotated; their plain versions for CPU tensors), 'slice' the plain torch
sweeps (shear-warp's 'xla' backend). ``streamed`` renders the unrotated
view by the seeded streamed decode (``march/streaming.py``).

The CLI (``cli.py fit_voxels_problem``, ``cmd_fit_voxels``) and the
benchmark's ``fit_voxels`` kind both build the job here
(:func:`fit_problem`) and step it with :func:`train_step`. Spans:
``voxel_fit.decode``, ``voxel_fit.view`` (one a view, forward),
``voxel_fit.loss``, ``voxel_fit.backward``, ``voxel_fit.adam``; counters
``voxel_fit.renders`` and ``voxel_fit.renders_rotated`` (a channel of a
view is one render).
"""

from __future__ import annotations

import torch

from vrdd_tpu_torch.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu_torch.core.transfer import grayscale_ramp
from vrdd_tpu_torch.io.synthetic import gaussian_blob_volume
from vrdd_tpu_torch.kernels.slice_vjp import pallas_slice_render_diff
from vrdd_tpu_torch.march.shearwarp import shearwarp_render_image
from vrdd_tpu_torch.march.slice import slice_render_image
from vrdd_tpu_torch.march.streaming import streaming_decode_render
from vrdd_tpu_torch.ops.gaussian import gaussian_stats
from vrdd_tpu_torch.utils import profiling

#: the cameras' distance from the volume's centre, on +z before rotation
DISTANCE = 4.0
#: the unrotated camera's origin
ORIGIN = (0.0, 0.0, DISTANCE)


def view_list(views: int, view_angle: float) -> list:
    """The first ``views`` (1 to 5) of (0, 0), (a, 0), (0, a), (-a, 0), (0,
    -a): rotations in degrees about x and y, ``a = view_angle``."""
    a = float(view_angle)
    out = [(0.0, 0.0), (a, 0.0), (0.0, a), (-a, 0.0), (0.0, -a)]
    return out[: max(1, views)]


def blob_truth(n: int, seed: int, device):
    """The ground truth ``(mu, sigma)`` of the job, each ``(n, n, n)``
    float32 on ``device``: a Gaussian-blob ``mu`` from ``seed`` and ``sigma =
    0.05 + 0.15 blob`` from ``seed + 1`` (numpy on the CPU, the same draws
    computed on a card)."""
    blob_dev = None if device.type == "cpu" else device
    mu = torch.as_tensor(gaussian_blob_volume((n, n, n), seed=seed,
                                              device=blob_dev), device=device)
    sigma = 0.05 + 0.15 * torch.as_tensor(
        gaussian_blob_volume((n, n, n), seed=seed + 1, device=blob_dev),
        device=device)
    return mu, sigma


def resolve_renderer(renderer: str, device) -> str:
    """'auto' is 'pallas' on the card and 'slice' on the CPU."""
    if renderer == "auto":
        return "pallas" if device.type == "cuda" else "slice"
    if renderer not in ("pallas", "slice"):
        raise ValueError(f"unknown renderer {renderer!r}; use auto / pallas "
                         "/ slice")
    return renderer


class VoxelFit:
    """The fit's renders and loss: ``views`` the (rx, ry) list, ``lut`` the
    9-entry grayscale ramp on the device, ``var_scale`` the variance
    channel's TF scale, ``targets`` the truth's renders (one ``(mean,
    variance)`` pair a view)."""

    def __init__(self, views, image, n_planes, lut, var_scale, renderer,
                 streamed=False):
        self.views, self.image, self.n_planes = list(views), image, n_planes
        self.lut, self.var_scale = lut, var_scale
        self.renderer, self.streamed = renderer, streamed
        self.targets = None
        # shear-warp's and the streamed decode's backend for the renderer
        self._backend = "pallas" if renderer == "pallas" else "xla"

    def _channel(self, vol, rx, ry, tf_scale):
        W = self.image
        if (rx, ry) == (0.0, 0.0):
            if self.renderer == "pallas":
                return pallas_slice_render_diff(
                    vol, ORIGIN, self.lut, transfer_scale=tf_scale, width=W,
                    height=W, n_planes=self.n_planes, wrt=("volume",))
            return slice_render_image(vol, ORIGIN, W, W, self.lut,
                                      transfer_scale=tf_scale,
                                      n_planes=self.n_planes)
        profiling.count("voxel_fit.renders_rotated")
        iv = inv_view_from_rotation_translation(rx, ry, (0.0, 0.0, -DISTANCE))
        return shearwarp_render_image(
            vol, iv, W, W, self.lut, transfer_scale=tf_scale,
            n_planes=self.n_planes, backend=self._backend, wrt=("volume",))

    def _streamed(self, mu, log_sigma, ch, tf_scale):
        W = self.image
        return streaming_decode_render(
            (mu, log_sigma),
            lambda t: gaussian_stats(t[0], torch.exp(t[1]))[..., ch],
            ORIGIN, self.lut, transfer_scale=tf_scale, width=W, height=W,
            n_planes=self.n_planes, wrt=("volume",), backend=self._backend)

    def render(self, mu, log_sigma) -> list:
        """One ``(mean, variance)`` pair of ``(H, W, 4)`` renders a view."""
        with profiling.annotate("voxel_fit.decode"):
            stats = gaussian_stats(mu, torch.exp(log_sigma))
        out = []
        for rx, ry in self.views:
            with profiling.annotate("voxel_fit.view"):
                profiling.count("voxel_fit.renders", 2)
                if self.streamed and (rx, ry) == (0.0, 0.0):
                    pair = (self._streamed(mu, log_sigma, 0, 1.0),
                            self._streamed(mu, log_sigma, 1, self.var_scale))
                else:
                    pair = (self._channel(stats[..., 0], rx, ry, 1.0),
                            self._channel(stats[..., 1], rx, ry,
                                          self.var_scale))
            out.append(pair)
        return out

    def loss(self, mu, log_sigma):
        """``(loss, renders)``: the mean over views of the two channels'
        mean squared errors against the targets."""
        renders = self.render(mu, log_sigma)
        with profiling.annotate("voxel_fit.loss"):
            loss = 0.0
            for (rm, rv), (tm, tv) in zip(renders, self.targets):
                loss = loss + torch.mean((rm - tm) ** 2) + torch.mean(
                    (rv - tv) ** 2)
            return loss / len(self.views), renders


def fit_problem(truth, *, views: int, view_angle: float, image: int,
                renderer: str, device, streamed: bool = False) -> VoxelFit:
    """The job for the ground truth ``truth = (mu, sigma)``: the view list
    (:func:`view_list`), ``image``-square renders through ``renderer``
    ('auto', 'pallas' or 'slice', :func:`resolve_renderer`) with ``2 n``
    planes, focal length 2 and shear-warp's m-grid at twice the image's
    samples, a 9-entry grayscale LUT, the variance's TF scale ``1 /
    max(sigma)^2``, and the targets rendered from ``truth``."""
    mu_true, sigma_true = truth
    fit = VoxelFit(
        view_list(views, view_angle), image, 2 * mu_true.shape[0],
        torch.as_tensor(grayscale_ramp(9), device=device),
        # variance lives in [0, ~sigma_max^2]: scale it into the TF domain
        1.0 / float(torch.max(sigma_true) ** 2),
        resolve_renderer(renderer, device), streamed)
    with torch.no_grad():
        fit.targets = fit.render(mu_true, torch.log(sigma_true))
    return fit


def train_step(fit: VoxelFit, opt, mu, log_sigma):
    """One step of the fit: zero the gradients, the loss over all views,
    its backward to ``(mu, log_sigma)``, ``opt``'s update. Returns ``(loss,
    renders)``, both still on the device (no wait)."""
    opt.zero_grad(set_to_none=True)
    loss, renders = fit.loss(mu, log_sigma)
    with profiling.annotate("voxel_fit.backward"):
        loss.backward()
    with profiling.annotate("voxel_fit.adam"):
        opt.step()
    return loss, renders
