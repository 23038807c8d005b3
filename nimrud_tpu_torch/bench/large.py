"""
The 10M-point stage (port of the reference's ``scripts/bench_large.py``):
the 10M-point tile (``make_bench_cloud(10_000_000, seed=1)``, the 1M
site at ten times the density), the bench model fit on a stride over its
first 9M points (``cloud[:9_000_000:9]``; the cloud stacks its classes,
so a prefix would hold one class) and served in the model's entry chunks
(``pipeline._serving_entry_chunk``).  Each step's ``stage`` and
``predict_staged`` (``with_diag=True``) on the host clock to synchronize,
one profiled window, chunks and launches a step, peak memory, overflow
counters, held-out accuracy on the last tenth of the rows (which the fit
never saw; all canopy), the byte model over the traced window.  Prints
one JSON line.

    python -m nimrud_tpu_torch.bench.large [--points N] [--device D]
"""

import statistics

from nimrud_tpu_torch.bench import _stage

N_LARGE = 10_000_000


def main(argv=None):
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.utils import workload

    stage = _stage.Stage("large", argv, N_LARGE)
    n = stage.n_points
    held = n // 10
    cloud, labels = workload.make_bench_cloud(n, seed=1)
    model = workload.make_bench_model(cloud, device=stage.device)
    fit_rows = slice(None, n - held, 9)
    _, fit_s = stage.seconds(lambda: model.fit(
        cloud[fit_rows], labels[fit_rows], sample=_stage.FIT_SAMPLE))
    stage.note(f"fit {fit_s:.2f} s on {len(cloud[fit_rows])} rows")

    def predict(staged):
        return model.predict_staged(staged, with_diag=True)

    # warm-up: the first stage sizes the 10M cloud's capacities
    staged, first_stage_s = stage.seconds(lambda: model.stage(cloud))
    _, warm_s = stage.seconds(lambda: predict(staged))
    stage.note(f"first stage {first_stage_s:.2f} s, warm-up step "
               f"{warm_s:.2f} s")
    pack = min((s[1] for s in staged["specs"]), key=lambda d: d.tile_edge)
    chunk = pipeline._serving_entry_chunk(pack.e_cap, pack.q_cap,
                                          model.serving_chunk_slots)

    stage.reset_peak()
    before = _stage.launches()
    stage_ms, predict_ms, outs = stage.steps(
        model.stage, predict, [cloud] * _stage.TIMED_RUNS)
    per_step = _stage.launched_since(before, _stage.TIMED_RUNS)
    peak = stage.peak_gib()
    trace = stage.trace([lambda: predict(staged)] * _stage.TRACE_RUNS)

    median = statistics.median(predict_ms)
    roofline = workload.roofline_payload(model, staged)
    if trace is not None:
        roofline = workload.roofline_rates(
            roofline, trace["window_ms_per_step"], stage.device_name)
    stage.note(f"predict_staged {median:.3f} ms (median)")
    return stage.emit({
        "points_per_sec": n / (median / 1e3),
        "timing_semantics": "host clock to torch.cuda.synchronize()",
        "scales": list(workload.BENCH_RADII),
        "fit_s": fit_s,
        "first_stage_s": first_stage_s,
        "warmup_step_s": warm_s,
        "entry_capacity": pack.e_cap,
        "q_cap": pack.q_cap,
        "entries_a_chunk": chunk,
        "chunks": 1 if chunk is None else -(-pack.e_cap // chunk),
        "predict_ms": _stage.summary(predict_ms),
        "stage_ms": _stage.summary(stage_ms),
        "step_with_stage_ms": _stage.summary(
            [s + p for s, p in zip(stage_ms, predict_ms)]),
        "trace": trace,
        "launches_per_step": per_step,
        "peak_gib": peak,
        **_stage.counters([diag for _, diag in outs]),
        "holdout_accuracy_last_tenth": _stage.accuracy(
            outs[-1][0], labels, slice(n - held, n)),
        "roofline": roofline,
    })


if __name__ == "__main__":
    main()
