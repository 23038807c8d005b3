"""
The comparison that decides ``correct``.

For each sampled point of a served cloud the gap is the larger of (a)
the largest difference between a served class probability and the
reference's, and (b) how far the reference's probability of the served
label lies below its best.  Where the reference left a pair of the
point undecided (``reference.features``), the point takes the smallest
gap over the ways of deciding it.

The numbers, over every sampled point of every cloud served in the
window:

* ``gap_median`` -- the median gap: how far a run's answers sit from the
  reference as a rule (the float32 program's rounding against a
  lower-precision control's);
* ``miss_share`` -- the share of points whose gap exceeds the
  configuration's ``miss_gap``, set above the largest gap that sound
  runs of the program give (``readings.py``): answers taken from another
  leaf or class than the reference's, and faults confined to a part of
  the points (a band over a region, an entry chunk, a tile), which move
  the median no more than the points they leave alone;
* ``gap_max`` -- the largest gap (reported, not compared).

A configuration names the numbers it compares and their limits
(``checks`` in its file); the run also compares ``failed_clouds`` with 0.
"""

import torch


def point_gaps(served_proba, served_labels, ref_proba, owner, n_rows):
    """Gap (n_rows,) float64 of each sampled point: ``served_proba``
    (n_rows, c) and ``served_labels`` (n_rows,) of the program, the
    reference's ``ref_proba`` (m, c) on feature rows ``owner`` (m,)."""
    p = served_proba.to(torch.float64)[owner]
    labels = served_labels.to(torch.int64)[owner]
    ref = ref_proba.to(torch.float64)
    proba_gap = (p - ref).abs().amax(1)
    label_gap = ref.amax(1) - ref.gather(1, labels[:, None])[:, 0]
    gap = torch.maximum(proba_gap, label_gap)
    gap = torch.nan_to_num(gap, nan=float("inf"))   # NaN answers miss
    out = torch.full((n_rows,), float("inf"), dtype=torch.float64,
                     device=gap.device)
    return out.scatter_reduce(0, owner, gap, "amin")


def numbers(gaps, miss_gap):
    """The comparison's numbers of the concatenated per-point gaps;
    ``miss_share`` counts the gaps over ``miss_gap``."""
    gaps = torch.cat(gaps) if gaps else torch.zeros(0, dtype=torch.float64)
    if gaps.numel() == 0:
        return {"gap_median": float("inf"), "miss_share": 1.0,
                "gap_max": float("inf"), "points": 0}
    return {"gap_median": float(gaps.median()),
            "miss_share": float((gaps > miss_gap).double().mean()),
            "gap_max": float(gaps.max()),
            "points": int(gaps.numel())}
