"""
The headline workload (copy of ``nimrud_tpu/utils/workload.py``
``make_bench_cloud`` and ``make_bench_model``): a 1M-point outdoor
LiDAR-style scene and the production serving configuration on it.
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
