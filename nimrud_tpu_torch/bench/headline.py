"""
The headline stage (port of the reference's ``scripts/bench_headline.py``):
the bench model (``make_bench_model``, packed backend, three bands, linear
classifier) fit on a 100k sample of the 1M-point bench cloud, then served.

``value`` is points per second of ``predict_staged`` on a staged cloud,
host clock to ``torch.cuda.synchronize()``: a staged cloud's serving
step, the reference's unit of work.  Beside it: ``stage`` alone, the
step with its ``stage`` (``step_with_stage_ms``, the end-to-end step),
``predict_stream`` over 4 clouds a cloud, one profiled window (busy,
idle share, top kernels), launches a step, peak memory, overflow
counters, accuracy and the byte model (``workload.roofline_payload``)
over the traced window.  Prints one JSON line.

    python -m nimrud_tpu_torch.bench.headline [--points N] [--device D]
"""

import statistics

from nimrud_tpu_torch.bench import _stage

N_STREAM = 4


def main(argv=None):
    from nimrud_tpu_torch.utils import workload

    stage = _stage.Stage("headline", argv, workload.BENCH_N_POINTS)
    n = stage.n_points
    cloud, labels = workload.make_bench_cloud(n)
    model = workload.make_bench_model(cloud, device=stage.device)
    _, fit_s = stage.seconds(
        lambda: model.fit(cloud, labels, sample=_stage.FIT_SAMPLE))
    stage.note(f"fit {fit_s:.2f} s")
    # warm-up: the first step sizes the capacities and loads the kernels
    staged = model.stage(cloud)
    (_, warm_diag), warm_s = stage.seconds(
        lambda: model.predict_staged(staged, with_diag=True))
    stage.note(f"warm-up step {warm_s:.2f} s")

    stage.reset_peak()
    before = _stage.launches()
    stage_ms, predict_ms, outs = stage.steps(
        model.stage, model.predict_staged, [cloud] * _stage.TIMED_RUNS)
    per_step = _stage.launched_since(before, _stage.TIMED_RUNS)
    peak = stage.peak_gib()
    _, stream_s = stage.seconds(
        lambda: list(model.predict_stream(cloud for _ in range(N_STREAM))))
    trace = stage.trace([lambda: model.predict_staged(staged)]
                        * _stage.TRACE_RUNS)
    _, diag = model.predict_staged(staged, with_diag=True)

    median = statistics.median(predict_ms)
    rate = n / (median / 1e3)
    roofline = workload.roofline_payload(model, staged)
    if trace is not None:
        roofline = workload.roofline_rates(
            roofline, trace["window_ms_per_step"], stage.device_name)
    stage.note(f"predict_staged {median:.3f} ms (median)")
    return stage.emit({
        "metric": (f"{n}-point cloud x 3 scales, predict_staged to "
                   f"synchronize on a staged cloud, {stage.device_name}"),
        "value": rate,
        "unit": "points/sec",
        "vs_baseline": rate / _stage.BASELINE_PTS_PER_SEC,
        "timing_semantics": "host clock to torch.cuda.synchronize()",
        "backend": model.backend,
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        "warmup_step_s": warm_s,
        "predict_ms": _stage.summary(predict_ms),
        "stage_ms": _stage.summary(stage_ms),
        "step_with_stage_ms": _stage.summary(
            [s + p for s, p in zip(stage_ms, predict_ms)]),
        "stream_ms_per_cloud": 1e3 * stream_s / N_STREAM,
        "trace": trace,
        "launches_per_step": per_step,
        "peak_gib": peak,
        **_stage.counters([warm_diag, diag]),
        "train_accuracy": _stage.accuracy(outs[-1], labels),
        "roofline": roofline,
    })


if __name__ == "__main__":
    main()
