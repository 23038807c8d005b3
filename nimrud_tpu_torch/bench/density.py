"""
The density stage (port of the reference's ``scripts/bench_density.py``,
its BASELINE config 4): the 1M-point serving step of the headline's
configuration on two density extremes of the same outdoor scene.

* ``urban`` -- a 45 x 45 m city block: ground at about 8x the headline's
  density, 24 walls, parapet clutter.  Neighbourhoods are fat (hundreds
  of candidates a query at 2 m) and even.
* ``veg`` -- a 220 x 220 m sparse scan: thin ground and 40 canopy blobs.
  Neighbourhoods are thin and heavy-tailed (most voxels near-empty, the
  blob cores dense).

The bench model (packed backend) is fit on a 100k sample of the regime's
cloud, then served (``_stage.Stage.serve``).  Beside the timings the line
has the reference's keys: ``mode``, ``regime``, ``scales``,
``site_extent_m``, the overflow counters (zero: the capacities are sized
on the cloud), ``train_accuracy``, the multi-bucket candidate capacities
the host sizing chose for each band (``cap_buckets_per_band``, read from
the staged specs) and the static plan's occupancy (``plan_occupancy``,
``multiscale.plan_report`` of the fused plan; no kernel runs).  Writes
no file; prints one JSON line.

    python -m nimrud_tpu_torch.bench.density {urban|veg} [--points N]
        [--device D]
"""

import numpy as np

from nimrud_tpu_torch.bench import _stage

N_POINTS = 1_000_000
REGIMES = ("urban", "veg")
OCCUPANCY_KEYS = ("edge", "entry_fill", "q_slot_fill", "e_cap", "q_cap")


def make_regime_cloud(regime, n=N_POINTS, seed=11):
    """The regime's cloud and labels (a copy of the reference's
    ``scripts/bench_density.py`` ``make_regime_cloud``): float32 (n, 3)
    in a random order, int32 labels."""
    rng = np.random.default_rng(seed)
    if regime == "urban":
        # 45x45 m core: dense ground + 24 walls + parapet clutter
        ground = rng.random((n // 2, 3)) * [45, 45, 0.12]
        walls = [rng.random((n // 64, 3)) * [0.25, 9, 12]
                 + [rng.random() * 40, rng.random() * 40, 0]
                 for _ in range(24)]
        clutter = rng.normal([22, 22, 12.5], [12, 12, 0.4],
                             (n - n // 2 - 24 * (n // 64), 3))
        cloud = np.vstack([ground, *walls, clutter])
        labels = np.concatenate([
            np.zeros(n // 2, np.int32),
            np.ones(24 * (n // 64), np.int32),
            np.full(len(clutter), 2, np.int32)])
    elif regime == "veg":
        # 220x220 m sparse scan: thin ground + 40 canopy blobs
        ground = rng.random((n // 2, 3)) * [220, 220, 0.3]
        blobs = [rng.normal(
            [rng.random() * 200 + 10, rng.random() * 200 + 10,
             5 + rng.random() * 6],
            [3.5, 3.5, 2.5], (n // 80, 3))
            for _ in range(40)]
        cloud = np.vstack([ground, *blobs])[:n]
        labels = np.concatenate([
            np.zeros(n // 2, np.int32),
            np.full(40 * (n // 80), 1, np.int32)])[:n]
    else:
        raise ValueError(f"unknown regime {regime!r}; one of {REGIMES}")
    order = rng.permutation(len(cloud))
    return cloud[order].astype(np.float32), labels[order]


def cap_buckets(specs):
    """Each band's candidate capacities from the staged band specs
    (``band.c_cap``: one int, or ``(caps, rank_bounds)`` from
    ``span_host.candidate_caps_split``)."""
    out = []
    for band in specs:
        caps, bounds = band.c_cap if isinstance(band.c_cap, tuple) \
            else ((band.c_cap,), ())
        out.append({"caps": [int(c) for c in caps],
                    "rank_bounds": [int(b) for b in bounds]})
    return out


def plan_occupancy(cloud, device):
    """The fused plan's occupancy of each bench band on ``cloud`` against
    itself (``plan_report``, packed backend)."""
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.utils import workload

    scaleset = [(edge, (radius,)) for edge, radius in
                zip(workload.BENCH_EDGES, workload.BENCH_RADII)]
    return [{k: row[k] for k in OCCUPANCY_KEYS}
            for row in multiscale.plan_report(
                cloud, cloud, scaleset, method="fused",
                tuning={"backend": "packed"}, device=device)]


def main(argv=None):
    from nimrud_tpu_torch.utils import workload

    stage = _stage.Stage("density", argv, N_POINTS, choices=REGIMES)
    regime = stage.choice
    cloud, labels = make_regime_cloud(regime, stage.n_points)
    model = workload.make_bench_model(cloud, backend="packed",
                                      device=stage.device)
    _, fit_s = stage.seconds(
        lambda: model.fit(cloud, labels, sample=_stage.FIT_SAMPLE))
    stage.note(f"fit {fit_s:.2f} s ({regime})")

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    serving, outs = stage.serve(model.stage, predict, cloud)
    return stage.emit({
        "mode": f"density_{regime}",
        "regime": regime,
        "scales": len(workload.BENCH_RADII),
        "site_extent_m": [round(float(x), 1)
                          for x in cloud.max(0) - cloud.min(0)],
        "fit_s": fit_s,
        **serving,
        "cap_buckets_per_band": cap_buckets(model.stage(cloud)["specs"]),
        "plan_occupancy": plan_occupancy(cloud, stage.device),
        "train_accuracy": _stage.accuracy(outs[-1][0], labels),
    })


if __name__ == "__main__":
    main()
