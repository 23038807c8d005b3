"""
The designated-search stage (port of the reference's
``scripts/bench_designated.py``): the bench model fit as in the headline
stage, ``stage_search`` of the cloud once (its seconds), then a stream of
jittering clouds (``default_rng(7)``, sigma 0.01 m: the cloud and jitters
of it) served against that one handle with ``with_diag=True``; each
step's ``stage(c, staged_search=handle)`` and ``predict_staged`` on the
host clock to synchronize, ``predict_stream`` over the same clouds, one
profiled window, launches a step, overflow counters.  Prints one JSON
line.

    python -m nimrud_tpu_torch.bench.designated [--points N] [--device D]
"""

import numpy as np

from nimrud_tpu_torch.bench import _stage

JITTER = 0.01


def main(argv=None):
    from nimrud_tpu_torch.utils import workload

    stage = _stage.Stage("designated", argv, workload.BENCH_N_POINTS)
    n = stage.n_points
    cloud, labels = workload.make_bench_cloud(n)
    model = workload.make_bench_model(cloud, device=stage.device)
    _, fit_s = stage.seconds(
        lambda: model.fit(cloud, labels, sample=_stage.FIT_SAMPLE))
    stage.note(f"fit {fit_s:.2f} s")
    handle, handle_s = stage.seconds(lambda: model.stage_search(cloud))
    rng = np.random.default_rng(7)
    stream = [cloud] + [
        (cloud + rng.normal(0, JITTER, cloud.shape)).astype(np.float32)
        for _ in range(_stage.TIMED_RUNS - 1)]

    def stage_on_map(c):
        return model.stage(c, staged_search=handle)

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    serving, outs = stage.serve(stage_on_map, predict, cloud, stream=stream)
    _, stream_s = stage.seconds(
        lambda: list(model.predict_stream(stream, staged_search=handle)))
    return stage.emit({
        "mode": "designated_search_stream",
        "stream": f"the cloud and {len(stream) - 1} jitters of it "
                  f"(sigma {JITTER} m), one staged search map",
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        "stage_search_once_s": handle_s,
        **serving,
        "stream_ms_per_cloud": 1e3 * stream_s / len(stream),
        "train_accuracy": _stage.accuracy(outs[0][0], labels),
    })


if __name__ == "__main__":
    main()
