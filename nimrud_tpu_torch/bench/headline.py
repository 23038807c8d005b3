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

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    # the warm-up step sizes the capacities and loads the kernels
    staged = model.stage(cloud)
    serving, outs = stage.serve(model.stage, predict, cloud, staged=staged)
    _, stream_s = stage.seconds(
        lambda: list(model.predict_stream(cloud for _ in range(N_STREAM))))
    rate = serving.pop("points_per_sec")
    return stage.emit({
        "metric": (f"{n}-point cloud x 3 scales, predict_staged to "
                   f"synchronize on a staged cloud, {stage.device_name}"),
        "value": rate,
        "unit": "points/sec",
        "vs_baseline": rate / _stage.BASELINE_PTS_PER_SEC,
        "backend": model.backend,
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        **serving,
        "stream_ms_per_cloud": 1e3 * stream_s / N_STREAM,
        "train_accuracy": _stage.accuracy(outs[-1][0], labels),
        "roofline": stage.roofline(model, staged, serving["trace"]),
    })


if __name__ == "__main__":
    main()
