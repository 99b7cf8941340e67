"""Camera / ray geometry (counterpart of ``vrdd_tpu/core/geometry.py``).

Semantics match the reference's NDC ray generation and slab ray-box test:

- Ray generation: ``u = (x / W) * 2 - 1`` (pixel corner, not center!),
  ``d = normalize(u, v, -focal)`` rotated by the 3x4 inverse view matrix, origin
  at the matrix translation column (volumeRender_kernel.cu:288-296).
- Inverse view matrix layout: rows of the camera-to-world transform, i.e. the
  transpose-of-columns extraction from the GL modelview
  (volumeRender.cpp:235-246).
- Slab test per intersectBox (volumeRender_kernel.cu:136-156).

Plain torch on the device of the inverse view (or of the rays).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def inv_view_from_rotation_translation(
    rot_x_deg: float, rot_y_deg: float, translation: Tuple[float, float, float]
) -> np.ndarray:
    """Build the 3x4 inverse view matrix the way the GL app does.

    Mirrors display() (volumeRender.cpp:225-246): the GL modelview is built as
    ``Rx(-rx) @ Ry(-ry) @ T(-t)`` and its top three rows (column-major
    extraction) form the camera-to-world matrix handed to the kernel.
    """
    rx = np.deg2rad(-rot_x_deg)
    ry = np.deg2rad(-rot_y_deg)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float64)
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float64)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rot_x @ rot_y
    t = np.eye(4, dtype=np.float64)
    t[:3, 3] = -np.asarray(translation, dtype=np.float64)
    mv = m @ t
    return mv[:3, :].astype(np.float32)


def default_benchmark_inv_view() -> np.ndarray:
    """Fixed benchmark view: camera at (0, 0, 4) looking down -z.

    Matches runSingleTest's hard-coded modelView (volumeRender.cpp:1024-1043).
    """
    return np.array(
        [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 4.0]],
        dtype=np.float32,
    )


def camera_rays(
    inv_view, width: int, height: int, focal: float = 2.0, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate per-pixel ray origins and directions.

    Returns ``(origin (3,), dirs (H, W, 3))`` on ``device`` (default: the
    inverse view's). The origin is shared by all rays (pinhole); directions
    are normalized in camera space *before* rotation, exactly like the
    reference (normalize then rotate, so world-space dirs stay unit under
    orthonormal rotations).
    """
    if device is None and isinstance(inv_view, torch.Tensor):
        device = inv_view.device
    inv_view = torch.as_tensor(inv_view, dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=inv_view.device)
    y = torch.arange(height, dtype=torch.float32, device=inv_view.device)
    u = (x / width) * 2.0 - 1.0  # (W,)
    v = (y / height) * 2.0 - 1.0  # (H,)
    vv, uu = torch.meshgrid(v, u, indexing="ij")  # (H, W)
    d_cam = torch.stack([uu, vv, -focal * torch.ones_like(uu)], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    rot = inv_view[:, :3]  # (3, 3), rows of camera-to-world
    dirs = d_cam @ rot.T  # r_i = sum_j rot[i, j] * d[j]
    origin = inv_view[:, 3]
    return origin, dirs


def intersect_box(
    origin: torch.Tensor,
    dirs: torch.Tensor,
    box_min: Tuple[float, float, float],
    box_max: Tuple[float, float, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab ray-box intersection.

    Returns ``(tnear, tfar, hit)`` with ``hit = tfar > tnear`` (note: the
    reference does NOT require ``tfar > 0``; rays whose box lies behind the
    camera still "hit" and composite one clamped sample — preserved).
    """
    bmin = torch.tensor(box_min, dtype=torch.float32, device=dirs.device)
    bmax = torch.tensor(box_max, dtype=torch.float32, device=dirs.device)
    inv_d = 1.0 / dirs  # inf on axis-parallel rays, like CUDA
    tbot = inv_d * (bmin - origin)
    ttop = inv_d * (bmax - origin)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    tnear = tmin.amax(dim=-1)
    tfar = tmax.amin(dim=-1)
    return tnear, tfar, tfar > tnear
