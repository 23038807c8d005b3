"""
Moment-slab conversion shared by the moment kernels (port of
``nimrud_tpu/ops/pallas/multiscale_kernel.py:moments_from_slabs`` and
``MOMENT_PAD``; plain math, not a kernel).

That file's Pallas kernel ``entry_moments`` is not ported yet (see
ROADMAP.md, Queue B #3).
"""

import torch

MOMENT_PAD = 16         # 10 moment columns padded to 16 per radius


def moments_from_slabs(slabs, centers, radii):
    """
    Raw moment slabs (E, Q, n_r * MOMENT_PAD) -> per-radius
    ``{"count", "mean_local", "mean", "cov"}`` statistics for the
    feature layouts.  ``centers``: (E, 3) entry centers restoring the
    global frame.
    """
    out = []
    for ri, _ in enumerate(radii):
        slab = slabs[:, :, ri * MOMENT_PAD:(ri + 1) * MOMENT_PAD]
        count = slab[..., 0]
        denom = torch.clamp(count, min=1.0)[..., None]
        mean_local = slab[..., 1:4] / denom
        mx, my, mz = mean_local.unbind(-1)
        outer = torch.stack(
            [mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz], dim=-1)
        out.append({
            "count": count,
            "mean_local": mean_local,
            "mean": mean_local + centers[:, None, :],
            "cov": slab[..., 4:10] / denom - outer,
        })
    return out
