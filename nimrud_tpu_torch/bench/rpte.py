"""
The rpte stage (port of the reference's ``scripts/bench_rpte.py``): the
headline stage's model with ``classifier="rpte"`` (the random-projection
tree ensemble, seed 0), grown on the device (``fit_device`` on the 100k
sample's features), then served: each step's ``stage`` and
``predict_staged`` (``with_diag=True``) on the host clock to
synchronize, one profiled window, launches a step, overflow counters,
accuracy, and the forest walk alone on a step's served feature rows
(``checks.served_features``), timed by CUDA events, with the levels it
walks.  Writes no file.  Prints one JSON line.

    python -m nimrud_tpu_torch.bench.rpte [--points N] [--device D]
"""

import statistics

from nimrud_tpu_torch.bench import _stage


def main(argv=None):
    from nimrud_tpu_torch.utils import checks, workload

    stage = _stage.Stage("rpte", argv, workload.BENCH_N_POINTS)
    n = stage.n_points
    cloud, labels = workload.make_bench_cloud(n)
    model = workload.make_bench_model(cloud, classifier="rpte",
                                      device=stage.device)
    _, fit_s = stage.seconds(
        lambda: model.fit(cloud, labels, sample=_stage.FIT_SAMPLE))
    stage.note(f"fit {fit_s:.2f} s")

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    staged = model.stage(cloud)
    _, warm_s = stage.seconds(lambda: predict(staged))
    stage.reset_peak()
    before = _stage.launches()
    stage_ms, predict_ms, outs = stage.steps(
        model.stage, predict, [cloud] * _stage.TIMED_RUNS)
    per_step = _stage.launched_since(before, _stage.TIMED_RUNS)
    peak = stage.peak_gib()
    trace = stage.trace([lambda: predict(staged)] * _stage.TRACE_RUNS)

    forest = model.classifier
    feats = checks.served_features(model, staged)
    walk_ms = stage.kernel_ms(lambda: forest.proba_device(feats))
    median = statistics.median(predict_ms)
    stage.note(f"predict_staged {median:.3f} ms (median), the walk alone "
               f"{walk_ms:.3f} ms")
    return stage.emit({
        "mode": "rpte_serving",
        "classifier": {"kind": "rpte", "n_estimators": forest.n_estimators,
                       "d_func": forest.d_func,
                       "max_depth": forest.max_depth_,
                       "levels_walked": forest.walk_depth_ + 1},
        "points_per_sec": n / (median / 1e3),
        "timing_semantics": "host clock to torch.cuda.synchronize()",
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        "warmup_step_s": warm_s,
        "predict_ms": _stage.summary(predict_ms),
        "stage_ms": _stage.summary(stage_ms),
        "step_with_stage_ms": _stage.summary(
            [s + p for s, p in zip(stage_ms, predict_ms)]),
        "walk_ms": walk_ms,
        "walk_timing": "CUDA events" if stage.cuda else "host clock",
        "walk_rows": int(feats.shape[0]),
        "trace": trace,
        "launches_per_step": per_step,
        "peak_gib": peak,
        **_stage.counters([diag for _, diag in outs]),
        "train_accuracy": _stage.accuracy(outs[-1][0], labels),
    })


if __name__ == "__main__":
    main()
