"""Similarity/fractal histogram decoding (counterpart of
``vrdd_tpu/ops/fractal.py``).

A fractal-coded histogram is ``(templateId, shift, flipFlag, nErrors)`` plus a
sparse error list. Decoding = take the template, optionally flip,
circular-shift, add the sparse errors (clamping at 0), renormalize — the
semantics of fractalDecoding / flexibleFractalDecoding + the error merge in
d_basicDataProcessing (volumeRender_kernel.cu:195-251, 775-839). Vectorized
over a batch of rows on the device of the templates, differentiable with
respect to the templates and the error values.

The errors are summed into a zero ``(B, n_bins)`` correction with
``scatter_add_`` over the valid slots, then added to the shifted template
and clamped once. JAX contracts a ``(B, E, n_bins)`` one-hot instead (17 GB
at 256^3 voxels x 8 errors x 32 bins); the result is the same. When one
row names a bin twice, both values land in that bin's correction before the
clamp (in slot order on the CPU, in atomic order on the card), as JAX's
contraction sums them. The reference applies errors one at a time with a
clamp after each (volumeRender_kernel.cu:817-820), which is the same only
for unique bins; the readers reject duplicates (``io/formats.py``).
"""

from __future__ import annotations

from typing import Optional

import torch


def _roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Row-wise circular shift: ``out[b, (i + shift[b]) % n] = x[b, i]``."""
    n = x.shape[-1]
    j = torch.arange(n, device=x.device)
    src = (j[None, :] - shift[:, None]) % n  # out[b, j] = x[b, j - shift]
    return torch.gather(x, 1, src)


def fractal_decode(
    template: torch.Tensor,
    shift,
    flip,
    error_bins: Optional[torch.Tensor] = None,
    error_values: Optional[torch.Tensor] = None,
    n_errors=None,
    renormalize: bool = True,
) -> torch.Tensor:
    """Decode one fractal-coded histogram.

    Args:
      template: ``(n_bins,)`` template frequencies.
      shift: scalar int circular shift.
      flip: scalar int/bool reflection flag.
      error_bins: ``(max_errors,)`` int bin ids (may be padded).
      error_values: ``(max_errors,)`` float corrections.
      n_errors: scalar int count of valid error entries.
      renormalize: divide by the post-merge total (guarded against 0).

    Returns the ``(n_bins,)`` decoded histogram.
    """
    template = torch.as_tensor(template, dtype=torch.float32)
    dev = template.device

    def row(v):
        return torch.as_tensor(v, device=dev).reshape(1)

    return fractal_decode_batch(
        template[None], row(shift), row(flip),
        None if error_bins is None else torch.as_tensor(error_bins)[None],
        None if error_values is None else torch.as_tensor(error_values)[None],
        None if n_errors is None else row(n_errors),
        renormalize=renormalize,
    )[0]


def fractal_decode_batch(
    templates: torch.Tensor,
    shift,
    flip,
    error_bins: Optional[torch.Tensor] = None,
    error_values: Optional[torch.Tensor] = None,
    n_errors=None,
    renormalize: bool = True,
) -> torch.Tensor:
    """Decode a batch of fractal-coded histograms.

    Args:
      templates: ``(B, n_bins)`` per-entry template rows (pre-gathered by
        templateId: ``all_templates[codebook[:, 0]]`` at the call site).
      shift / flip: ``(B,)`` ints.
      error_bins / error_values: ``(B, E)`` padded sparse errors; a bin id
        outside ``[0, n_bins)`` adds nothing (it matches no bin of JAX's
        one-hot).
      n_errors: ``(B,)`` valid counts.

    Returns ``(B, n_bins)`` on the device of ``templates``.
    """
    templates = torch.as_tensor(templates, dtype=torch.float32)
    dev = templates.device
    n = templates.shape[-1]
    flip = torch.as_tensor(flip, device=dev)
    flipped = torch.where((flip != 0)[:, None], torch.flip(templates, (-1,)),
                          templates)
    decoded = _roll_rows(flipped, torch.as_tensor(shift, device=dev).long())

    if error_bins is not None:
        eb = torch.as_tensor(error_bins, device=dev).long()
        ev = torch.as_tensor(error_values, dtype=torch.float32, device=dev)
        valid = (eb >= 0) & (eb < n)
        if n_errors is not None:
            k = torch.arange(eb.shape[-1], device=dev)
            valid &= k[None, :] < torch.as_tensor(n_errors,
                                                  device=dev).long()[:, None]
        corr = torch.zeros_like(decoded).scatter_add_(
            1, torch.where(valid, eb, 0), torch.where(valid, ev, 0.0))
        decoded = torch.clamp(decoded + corr, min=0.0)

    if renormalize:
        total = torch.sum(decoded, dim=-1, keepdim=True)
        decoded = torch.where(
            total > 0.0, decoded / torch.where(total > 0.0, total, 1.0),
            decoded)
    return decoded
