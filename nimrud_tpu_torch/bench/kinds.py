"""
The kinds stage (port of the reference's ``scripts/bench_kinds.py``): the
headline's serving configuration with another feature layout, fit on a
100k sample of the 1M-point bench cloud, then served.

* ``vector`` -- the attribute means of two columns
  (``workload.make_bench_attributes``: the label plus noise and a uniform
  column, seed 3, the reference's), passed to ``fit`` and to every
  ``stage``; it runs the attribute instances of ``packed_moments`` in the
  extraction and its chebyshev instances in the packed attribute interp.
* ``oriented`` -- the oriented eigenvector features, on the euclidean
  instance of ``packed_moments``.

Everything but the layout (and the attributes) is the headline's, so the
step against the headline stage's is the kind's cost.  The line has the
reference's keys (``mode``, ``kind``, ``attr_width``, ``scales``,
``overflow_counters``, ``counters_all_zero``, ``train_accuracy``) and the
harness's timings (``_stage.Stage.serve``).  Writes no file; prints one
JSON line.

    python -m nimrud_tpu_torch.bench.kinds {vector|oriented} [--points N]
        [--device D]
"""

from nimrud_tpu_torch.bench import _stage

KINDS = ("vector", "oriented")


def main(argv=None):
    from nimrud_tpu_torch.utils import workload

    stage = _stage.Stage("kinds", argv, workload.BENCH_N_POINTS,
                         choices=KINDS)
    kind = stage.choice
    cloud, labels = workload.make_bench_cloud(stage.n_points)
    attrs = workload.make_bench_attributes(labels) if kind == "vector" \
        else None
    model = workload.make_bench_model(cloud, backend="packed", kind=kind,
                                      device=stage.device)
    _, fit_s = stage.seconds(lambda: model.fit(
        cloud, labels, sample=_stage.FIT_SAMPLE, attributes=attrs))
    stage.note(f"fit {fit_s:.2f} s (kind={kind})")

    def stage_cloud(c):
        return model.stage(c, attributes=attrs)

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    serving, outs = stage.serve(stage_cloud, predict, cloud)
    return stage.emit({
        "mode": f"{kind}_serving",
        "kind": kind,
        "attr_width": None if attrs is None else int(attrs.shape[1]),
        "scales": len(workload.BENCH_RADII),
        "fit_s": fit_s,
        **serving,
        "train_accuracy": _stage.accuracy(outs[-1][0], labels),
    })


if __name__ == "__main__":
    main()
