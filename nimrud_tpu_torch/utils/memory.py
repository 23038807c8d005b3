"""
Device-memory budgeting for automatic out-of-core extraction (port of
``nimrud_tpu/utils/memory.py``).

The reference spilled neighborhood tensors to disk and checked GPU
memory before every launch (reference: nimrud/prototypes/mso.py:375-466,
apc.py:580-584).  Shapes here are static, so the budget decision moves
to planning time: project the device footprint of a fused extraction
from its static capacities, and if it exceeds the budget, route the
workload through the buffered-partition outer loop (``NestedOctree``
tiles with halo) with a partition population chosen to fit.

:func:`projected_fused_bytes` and :func:`auto_partition_population`
keep the reference's formula.  :func:`device_hbm_budget` reads the card
through ``torch.cuda.mem_get_info``; it catches nothing, so a device it
cannot read raises instead of hiding behind a default.
"""

import numpy as np
import torch

#: the reference's documented budget off a TPU (one v5e core's 16 GB
#: less headroom), returned for a CPU device
DEFAULT_HBM_BUDGET = 12 * 1024 ** 3

#: share of the card's memory the budget leaves to the program (the
#: reference's 0.85 of the device's ``bytes_limit``)
USABLE_SHARE = 0.85


def device_hbm_budget(device="cuda"):
    """Usable device memory in bytes: 0.85 of a CUDA device's total
    memory (``torch.cuda.mem_get_info``), or ``DEFAULT_HBM_BUDGET`` for a
    CPU device."""
    device = torch.device(device)
    if device.type == "cpu":
        return DEFAULT_HBM_BUDGET
    if device.type != "cuda":
        raise ValueError(f"no memory budget for device {device}")
    _, total = torch.cuda.mem_get_info(device)
    return int(total * USABLE_SHARE)


def _pow2(n, minimum=128):
    out = minimum
    while out < n:
        out *= 2
    return out


def projected_fused_bytes(n_query, n_search, scaleset, *,
                          bounds_span=None, q_cap=64, m=3,
                          entry_batch=256, n_attr=0):
    """
    Rough upper bound on the device footprint (bytes) of one fused
    extraction: resident tables + per-batch transients, summed over
    bands (planning conservatively sums the resident tables).

    ``bounds_span``: per-axis extent of the data (meters); defaults to a
    cube sized so the search cloud at its densest still fits -- callers
    that know the real bounds should pass them.
    """
    q_bucket = _pow2(int(n_query))
    s_bucket = _pow2(int(n_search))
    total = (q_bucket + s_bucket) * 3 * 4           # clouds
    total += s_bucket * (3 + n_attr) * 4            # voxel centers+attrs
    width_total = 0

    span = np.asarray(
        [100.0, 100.0, 10.0] if bounds_span is None else bounds_span,
        np.float64)
    for edge, radii in scaleset:
        tile = max(radii)
        dims = np.maximum(np.ceil(span / tile), 1)
        dims = np.ceil(dims / 16) * 16              # make_spec rounding
        n_grid = float(dims.prod())
        qdims = np.ceil(dims / m)
        n_qgrid = float(qdims.prod())
        if edge and edge > 0:
            per_axis = int(np.ceil(tile / max(edge, 1e-9))) + 1
            s_cap = _pow2(per_axis ** 3, minimum=8)
        else:
            s_cap = _pow2(max(int(n_search) // max(int(n_grid), 1), 1),
                          minimum=8)
        n_off = (m + 2) ** 3
        e_cap = n_qgrid + q_bucket // q_cap + entry_batch
        # resident: candidate table + entry tables + sort scratch
        total += (n_grid + 1) * s_cap * 4
        total += e_cap * (q_cap + n_off + 3) * 4
        total += s_bucket * 3 * 4
        # transient per entry batch: gathered points + aug + d2 + masks
        flat = n_off * s_cap
        total += entry_batch * flat * (3 + 11 + n_attr) * 4
        total += entry_batch * q_cap * flat * 4 * 2
        width_total += 4 * len(radii)                # minimal-ish width
    total += q_bucket * max(width_total, 1) * 4 * 2  # features + scatter
    return int(total)


def auto_partition_population(n_query, n_search, scaleset, *,
                              budget=None, bounds_span=None, device="cuda",
                              **kwargs):
    """
    None if the whole problem fits the budget (default
    :func:`device_hbm_budget` of ``device``); otherwise the largest
    halved population for the buffered-partition outer loop whose
    projected footprint fits.
    """
    budget = device_hbm_budget(device) if budget is None else int(budget)
    if projected_fused_bytes(
            n_query, n_search, scaleset,
            bounds_span=bounds_span, **kwargs) <= budget:
        return None
    population = int(n_search)
    while population > 1024:
        population //= 2
        # partitions bound both clouds; extent shrinks with population
        # (conservative: keep the full span, which over-estimates)
        if projected_fused_bytes(
                min(n_query, population), population, scaleset,
                bounds_span=bounds_span, **kwargs) <= budget:
            return population
    return 1024
