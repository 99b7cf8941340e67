"""1-D RGBA transfer functions (counterpart of ``vrdd_tpu/core/transfer.py``).

The LUT is a ``(n_lut, 4)`` float32 table, linearly filtered and clamped at
lookup time: by :func:`apply_transfer_function` (the scan marcher), by the
sweeps (``march/slice.py`` ``_tf_onehot_matmul``) and by the CUDA kernel's
two-tap form.
"""

from __future__ import annotations

import numpy as np
import torch

from vrdd_tpu_torch.core.sampling import sample_linear_1d


def default_transfer_function() -> np.ndarray:
    """The reference's 9-entry rainbow ramp (volumeRender_kernel.cu:2323-2326)."""
    return np.array(
        [
            [0.0, 0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0, 1.0],
            [1.0, 0.5, 0.0, 1.0],
            [1.0, 1.0, 0.0, 1.0],
            [0.0, 1.0, 0.0, 1.0],
            [0.0, 1.0, 1.0, 1.0],
            [0.0, 0.0, 1.0, 1.0],
            [1.0, 0.0, 1.0, 1.0],
            [0.0, 0.0, 0.0, 0.0],
        ],
        dtype=np.float32,
    )


def grayscale_ramp(n: int = 16) -> np.ndarray:
    """Grayscale ramp LUT (the CPU-runnable config in BASELINE.json)."""
    g = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return np.stack([g, g, g, g], axis=-1)


def apply_transfer_function(
    lut: torch.Tensor, sample: torch.Tensor, offset=0.0, scale=1.0
) -> torch.Tensor:
    """``tex1D(transferTex, (sample - offset) * scale)`` (volumeRender_kernel.cu:683-684).

    Returns RGBA of shape ``sample.shape + (4,)``.
    """
    return sample_linear_1d(lut, (sample - offset) * scale)
