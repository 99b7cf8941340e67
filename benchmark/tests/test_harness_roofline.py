"""The roofline's count, held to hand arithmetic at a small size."""

import torch

from benchmark import inputs
from benchmark.reference import sweep as ref
from benchmark.roofline import count


def test_operation_constants_are_their_derivations():
    # resample 9, LUT 20, opacity 3, over 13
    assert count.FWD_SAMPLE_OPS == 45
    # P 9, S 1, T 2, d_a 5, d_rgb 3 + 3 + 6, gate 3, d_lut 16, dq 12 + 2,
    # scatter 12
    assert count.REV_SAMPLE_OPS == 74
    assert count.decode_voxel_ops("mean", 16) == 48
    assert count.decode_voxel_ops("entropy", 16) == 49 + 64


def test_fit_step_bound_at_a_small_size():
    """A 2^3 x 2-bin volume to a 2 x 2 image: of the four rays (slopes 0.5
    and 0 on each axis, from z = 4) only the one of slopes (0, 0) stays in
    the box, on both planes, and at a density of 1e-4 it does not reach
    the cutoff, so the step needs 2 samples."""
    hist = torch.full((2, 2, 2, 2), 0.5)
    rows = torch.as_tensor(inputs.unit_decode_rows("mean", 2))
    *_, live = ref.fit_step(hist, rows, "mean", inputs.rainbow_lut(), 1e-4,
                            0.0, 1.0, width=2, height=2, origin=(0, 0, 4),
                            focal=2.0, chunk=1, dtype=torch.float32)
    assert live == 2
    n_bytes, n_ops = count.fit_step_work(voxels=8, bins=2, storage_bytes=2,
                                         width=2, height=2, n_lut=9,
                                         live_samples=live, stat="mean")
    # the histograms read and their gradient written (2 x 8 x 2 x 2 B), the
    # image (4 x 16 B), the LUT read and its gradient written (2 x 9 x 16 B)
    assert n_bytes == 64 + 64 + 288
    # 2 samples x (45 + 74) and 8 voxels x (2 x 2 + 2)
    assert n_ops == 2 * 119 + 8 * 6
    t, by = count.bound_s(n_bytes, n_ops)
    assert by == "bytes" and t == n_bytes / 3.35e12


def test_full_size_bound_is_set_by_bytes():
    """The 512^3 x 16 bf16 step: 4.29 GB read and 4.29 GB written, 2.6 ms
    at 3.35 TB/s, whatever the samples."""
    n_bytes, n_ops = count.fit_step_work(
        voxels=512 ** 3, bins=16, storage_bytes=2, width=1024, height=1024,
        n_lut=9, live_samples=512 * 1024 * 1024, stat="mean")
    t, by = count.bound_s(n_bytes, n_ops)
    assert by == "bytes" and 2.55e-3 < t < 2.58e-3
