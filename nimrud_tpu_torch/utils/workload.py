"""
The headline workload (copy of ``nimrud_tpu/utils/workload.py``
``make_bench_cloud`` and ``make_bench_model``): a 1M-point outdoor
LiDAR-style scene and the production serving configuration on it; and
the benchmark's byte model of a serving step (``roofline_payload``,
``roofline_rates``, the reference's formula).

Not ported: the reference's ``project_v5p`` and its v5e attribution
table (a TPU projection) and ``lower_predict`` (an XLA lowering).
"""

import numpy as np

BENCH_N_POINTS = 1_000_000
BENCH_EDGES = (0.25, 0.5, 1.0)
BENCH_RADII = (0.5, 1.0, 2.0)


def make_bench_cloud(n=BENCH_N_POINTS, seed=0):
    """Ground plane, eight building walls, vegetation canopy; labels
    0 / 1 / 2."""
    rng = np.random.default_rng(seed)
    ground = rng.random((n // 2, 3)) * [100, 100, 0.15]
    walls = [rng.random((n // 16, 3)) * [0.2, 12, 9]
             + [rng.random() * 90, rng.random() * 90, 0]
             for _ in range(8)]
    canopy = rng.normal([60, 60, 7], [15, 15, 2], (n // 4, 3))
    cloud = np.vstack([ground, *walls, canopy]).astype(np.float32)[:n]
    labels = np.concatenate([
        np.zeros(n // 2, np.int32),
        np.ones(8 * (n // 16), np.int32),
        np.full(n // 4, 2, np.int32)])[:n]
    return cloud, labels


def make_bench_model(cloud, backend="packed", epochs=10, kind="minimal",
                     classifier="linear", classifier_kwargs=None,
                     device="cuda", **kwargs):
    """The serving configuration bench.py measures: three bands
    (edge, radius) (0.25, 0.5), (0.5, 1.0), (1.0, 2.0), linear
    classifier, uint16 uploads, fixed site bounds, trimmed entries, on
    ``device``; ``backend`` "packed", "pallas" (span serving) or "xla"
    (the candidate-table path, no kernel).  ``kind`` is the feature
    layout, "minimal" for the headline workload; the port serves
    "geometric", "oriented", "covariance", "eigen", "sazo" and "vector"
    too, everything else identical.
    ``classifier="rpte"`` is the reference's ``scripts/bench_rpte.py``
    model (the random-projection-tree ensemble, ``{"seed": 0}`` unless
    ``classifier_kwargs`` say otherwise).  ``kwargs`` go to
    ``GeometryClassifier``: ``exclude_radius=e`` makes the legacy
    self-exclusion model, which fits and predicts through the per-band
    extraction (``predict_device`` / ``predict``; its ``stage``
    raises); ``serving_chunk_slots`` bounds the serving step's entry
    slots a chunk; ``method`` / ``chunk_size`` are the extraction's."""
    from nimrud_tpu_torch.pipeline import GeometryClassifier

    if classifier_kwargs is None:
        classifier_kwargs = {"epochs": epochs, "seed": 0} \
            if classifier == "linear" else {"seed": 0}
    scaleset = [(edge, (radius,))
                for edge, radius in zip(BENCH_EDGES, BENCH_RADII)]
    return GeometryClassifier(
        scaleset, kind=kind, classifier=classifier,
        classifier_kwargs=classifier_kwargs,
        transfer_dtype="uint16", backend=backend,
        bounds=(cloud.min(0), cloud.max(0)), trim_entries=True,
        device=device, **kwargs)


def make_bench_attributes(labels, seed=3):
    """The two attribute columns the reference's ``vector`` benchmark
    (``scripts/bench_kinds.py``) serves with the bench scene: the label
    plus 0.05 Gaussian noise (an intensity-like column with class signal)
    and a uniform column, float32 (n, 2)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [labels + 0.05 * rng.standard_normal(len(labels)),
         rng.random(len(labels))], axis=1).astype(np.float32)


# The card whose peak HBM rate ``pct_of_peak`` is reckoned against: the
# H100 SXM 80GB HBM3 of the kernels' bounds (``HBM_BYTES``).
PEAK_CARD = "H100 80GB HBM3"


def _packed_lane_total(c_cap, e_cap, entry_chunk):
    """Candidate lanes one band's packed gather moves a step: every entry
    slot (live or dead -- dead slots fetch the FAR sentinel row) costs
    its rank bucket's capacity.  ``c_cap`` is an int or (caps, bounds)
    as ``span_host.candidate_caps_split`` gives it; the bucket edges
    restart in each chunk of ``entry_chunk`` entries (None: one chunk)."""
    if isinstance(c_cap, tuple):
        caps, bounds = c_cap
    else:
        caps, bounds = (int(c_cap),), ()
    chunk = e_cap if entry_chunk is None else int(entry_chunk)
    edges = (0,) + tuple(bounds) + (chunk,)
    total = 0
    for start in range(0, e_cap, chunk):
        length = min(chunk, e_cap - start)
        for cap, a, b in zip(caps, edges[:-1], edges[1:]):
            total += max(min(b, length) - min(a, length), 0) * cap
    return total


def roofline_payload(model, staged):
    """Single-touch payload model of a packed serving step's data
    movement (the reference's formula, so both packages give the same
    bytes for the same specs): every major buffer counted once a read
    and once a write at its static (padded) device shape, each sort one
    read + write pass.  A lower bound on the bytes the step moves.
    The port's step moves others too, not counted: the uploads, the
    (q_bucket,) query plan's int64 keys and scans, the moment slabs, a
    ragged last entry chunk's buckets sized for that chunk alone.

    ``staged`` is :meth:`GeometryClassifier.stage`'s dict (``specs``,
    ``q_bucket``, ``s_bucket``, ``n_query``).  Returns the byte counts
    by movement, the candidate and query lanes, the total and the bytes
    a point."""
    from nimrud_tpu_torch import pipeline

    specs = staged["specs"]
    n_q = int(staged["q_bucket"])
    n_s = int(staged["s_bucket"])
    rows = {}
    # shared query plan: qid sort carrying 3 coord payloads, the two
    # rank-compaction sorts (key+payload), the caller-order label sort
    rows["plan_sort"] = 2 * n_q * (4 + 12)
    rows["rank_sorts"] = 2 * 2 * n_q * (4 + 4)
    rows["label_unsort"] = 2 * n_q * (4 + 4)
    rows["unique_sorts"] = 0
    rows["span_tables"] = 0
    cand_lanes = 0
    qt_lanes = 0
    # every band's candidate gather runs over the shared pack plan (the
    # finest band's grid), the basis its capacities were sized on
    pack = min((s.dev_spec for s in specs), key=lambda d: d.tile_edge)
    chunk = pipeline._serving_entry_chunk(
        pack.e_cap, pack.q_cap, model.serving_chunk_slots)
    for band in specs:
        # per-band voxel dedup: key sort + (tile-id, key) compaction sort
        rows["unique_sorts"] += 2 * n_s * 4 + 2 * n_s * (4 + 4)
        sv = int(band.cap) if band.cap else n_s
        # span starts/lens scans + counts scatter over the band's search
        rows["span_tables"] += 2 * sv * 4 * 2
        if band.c_cap is not None:
            cand_lanes += _packed_lane_total(band.c_cap, pack.e_cap, chunk)
            qt_lanes = max(qt_lanes, pack.e_cap * pack.q_cap)
    # candidate pack gather: 4 B index read + 12 B row read + 12 B write
    rows["candidate_gather"] = cand_lanes * (4 + 12 + 12)
    # the kernel reads the packed block and the query block again
    rows["kernel_reads"] = cand_lanes * 12 + qt_lanes * 12
    # shared (E, q_cap) query gather (once for all bands)
    rows["qt_gather"] = qt_lanes * (4 + 12 + 12)
    total = int(sum(rows.values()))
    return {
        "model": ("single-touch payload bytes at static device shapes "
                  "(lower bound; sorts counted one read+write pass)"),
        "movements_bytes": {k: int(v) for k, v in rows.items()},
        "candidate_lanes": int(cand_lanes),
        "qt_lanes": int(qt_lanes),
        "bytes_total": total,
        "bytes_per_point": round(total / max(int(staged["n_query"]), 1),
                                 1),
    }


def roofline_rates(payload, window_ms, device_name):
    """``payload`` with its achieved rate over ``window_ms`` (GB/s) and,
    on the ``PEAK_CARD`` (the H100 SXM 80GB HBM3), the peak HBM rate and
    the achieved share of it; any other card gets neither."""
    out = dict(payload)
    gbps = payload["bytes_total"] / (window_ms * 1e-3) / 1e9
    out["window_ms"] = window_ms
    out["achieved_payload_gbps"] = gbps
    out["device"] = device_name
    if PEAK_CARD in device_name:
        from nimrud_tpu_torch.ops.kernels.multiscale_kernel import HBM_BYTES
        out["peak_hbm_gbps"] = HBM_BYTES / 1e9
        out["pct_of_peak"] = 100.0 * gbps / out["peak_hbm_gbps"]
    return out
