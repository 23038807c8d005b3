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

    serving, outs = stage.serve(model.stage, predict, cloud)
    forest = model.classifier
    feats = checks.served_features(model, model.stage(cloud))
    walk_ms = stage.kernel_ms(lambda: forest.proba_device(feats))
    stage.note(f"the walk alone {walk_ms:.3f} ms")
    return stage.emit({
        "mode": "rpte_serving",
        "classifier": {"kind": "rpte", "n_estimators": forest.n_estimators,
                       "d_func": forest.d_func,
                       "max_depth": forest.max_depth_,
                       "levels_walked": forest.walk_depth_ + 1},
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        **serving,
        "walk_ms": walk_ms,
        "walk_timing": "CUDA events" if stage.cuda else "host clock",
        "walk_rows": int(feats.shape[0]),
        "train_accuracy": _stage.accuracy(outs[-1][0], labels),
    })


if __name__ == "__main__":
    main()
