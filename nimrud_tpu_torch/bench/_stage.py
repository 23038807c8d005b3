"""
What the benchmark stages share (the reference repeats it in each of
its ``scripts/bench_*.py``): the command line (``--device``,
``--points``, and the kind or regime of a variant stage), warm-up
outside the timed window, step walls on the host clock ending in
``torch.cuda.synchronize()``, one ``torch.profiler`` trace of a few
steps read as the card's window, busy time, idle share and top kernels
(``utils.profiling``), the moment kernels' launch counts, the peak
device memory, and the one JSON line a stage prints.

A stage runs on the card unless ``--device cpu`` is given; on the CPU
it traces nothing (a CPU trace has no device events) and its numbers
are the CPU's, named by the ``device`` it reports.  A failure raises:
no stage turns an exception into a field of its line.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time

TIMED_RUNS = 5         # steps each wall is taken over
TRACE_RUNS = 2         # steps in the traced window
TOP_OPS = 8            # device kernels listed by total time
FIT_SAMPLE = 100_000   # training rows of every stage's fit
BASELINE_PTS_PER_SEC = 5000.0 / 3   # the reference CPU pipeline at 3 scales


def _counters():
    """(name, wrapper, attribute) of every kernel launch counter, named
    as ``chip_smoke.py`` names them; read at call time, so a wrapper
    replaced on its module is the one read."""
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    rows = []
    for name, fn in (("packed_moments", pm.packed_moments),
                     ("span_moments", gk.span_moments),
                     ("entry_moments", mk.entry_moments)):
        for attr in vars(fn):
            if attr.endswith("launches"):
                suffix = attr[:-len("launches")].rstrip("_")
                rows.append((name + ("_" + suffix if suffix else ""), fn,
                             attr))
    return rows


def launches():
    """Every kernel's launches so far in this process."""
    return {name: getattr(fn, attr) for name, fn, attr in _counters()}


def launched_since(before, runs=1):
    """Launches since the ``before`` counts, per run; kernels that did not
    launch are left out."""
    now = launches()
    return {k: (v - before.get(k, 0)) / runs for k, v in now.items()
            if v != before.get(k, 0)}


def summary(ms):
    """Median, spread (largest less smallest) and every sample of a list
    of milliseconds."""
    return {"median_ms": statistics.median(ms),
            "spread_ms": max(ms) - min(ms), "runs": len(ms), "ms": ms}


def trace_summary(events, runs):
    """The card's numbers of a chrome trace's events over ``runs``
    steps: window (first device start to last end) and busy time (the
    union of device intervals) a step, idle share, device events, and
    the top kernels by total time."""
    from nimrud_tpu_torch.utils import profiling
    busy_us, window_us = profiling.device_track_stats(events)
    return {"window_ms_per_step": window_us / 1e3 / runs,
            "busy_ms_per_step": busy_us / 1e3 / runs,
            "idle_share": 1.0 - busy_us / window_us,
            "device_events": len(profiling.device_events(events)),
            "traced_steps": runs,
            "top_ops": [{"name": name, "total_ms": total, "count": count}
                        for total, count, name in
                        profiling.device_op_table(events, top=TOP_OPS)]}


class Stage:
    """One stage's process: its arguments, device and clock."""

    def __init__(self, name, argv, default_points, choices=None):
        """``choices``: the values of the stage's one positional argument
        (a variant stage's kind or regime; the first is the default),
        kept as ``self.choice``; any other value exits with argparse's
        usage error."""
        import torch

        parser = argparse.ArgumentParser(
            prog=f"python -m nimrud_tpu_torch.bench.{name}")
        if choices:
            parser.add_argument("choice", nargs="?", choices=choices,
                                default=choices[0],
                                help=f"one of {', '.join(choices)} "
                                     f"(default {choices[0]})")
        parser.add_argument("--device", default="cuda",
                            help="torch device (default cuda)")
        parser.add_argument("--points", type=int, default=default_points,
                            help=f"cloud size (default {default_points})")
        args = parser.parse_args(argv)
        self.name = name
        self.choice = getattr(args, "choice", None)
        self.n_points = args.points
        self.device = torch.device(args.device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError(f"{name}: no CUDA device (pass --device "
                               "cpu to run on the CPU)")
        self.device_name = torch.cuda.get_device_name(self.device) \
            if self.cuda else "cpu"
        self.t0 = time.perf_counter()

    def note(self, msg):
        print(f"[{self.name} +{time.perf_counter() - self.t0:.1f}s] {msg}",
              file=sys.stderr, flush=True)

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def seconds(self, fn):
        """(result, seconds) of ``fn()`` to synchronize."""
        self.sync()
        start = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - start

    def steps(self, stage, predict, inputs):
        """Serve each of ``inputs``: ``stage(x)`` then ``predict(staged)``,
        each part on the host clock to synchronize.  Returns the stage
        and predict walls (ms) and the outputs of ``predict``, copied to
        the host after each step's clock stops (so that the steps' peak
        memory holds one step's outputs)."""
        stage_ms, predict_ms, outs = [], [], []
        for x in inputs:
            staged, s = self.seconds(lambda: stage(x))
            out, p = self.seconds(lambda: predict(staged))
            stage_ms.append(1e3 * s)
            predict_ms.append(1e3 * p)
            outs.append(_on_host(out))
            del staged, out
        return stage_ms, predict_ms, outs

    def serve(self, stage, predict, cloud, staged=None, stream=None):
        """The serving part of a stage's line: one warm-up step outside
        the window (``predict`` of ``staged``, else of ``stage(cloud)``),
        the timed steps (:meth:`steps`) of ``stream`` (default
        :data:`TIMED_RUNS` times ``cloud``; ``predict`` returns (labels,
        diagnostics)), the launches a step, the peak memory over the
        timed steps, one traced window of ``predict`` on the warm-up's
        staged cloud, and the overflow counters of every timed step.
        Returns the line's fields and the timed steps' outputs."""
        stream = [cloud] * TIMED_RUNS if stream is None else stream
        staged = stage(cloud) if staged is None else staged
        _, warm_s = self.seconds(lambda: predict(staged))
        self.reset_peak()
        before = launches()
        stage_ms, predict_ms, outs = self.steps(stage, predict, stream)
        per_step = launched_since(before, len(stream))
        peak = self.peak_gib()
        trace = self.trace([lambda: predict(staged)] * TRACE_RUNS)
        median = statistics.median(predict_ms)
        self.note(f"warm-up step {warm_s:.2f} s, predict_staged "
                  f"{median:.3f} ms (median)")
        return {"points_per_sec": self.n_points / (median / 1e3),
                "timing_semantics": "host clock to torch.cuda.synchronize()",
                "warmup_step_s": warm_s,
                "predict_ms": summary(predict_ms),
                "stage_ms": summary(stage_ms),
                "step_with_stage_ms": summary(
                    [s + p for s, p in zip(stage_ms, predict_ms)]),
                "trace": trace,
                "launches_per_step": per_step,
                "peak_gib": peak,
                **counters([diag for _, diag in outs])}, outs

    def trace(self, steps):
        """Trace ``steps`` (callables, run in turn, then synchronize) and
        summarize the card's part (:func:`trace_summary`); None on the
        CPU."""
        if not self.cuda:
            return None
        from nimrud_tpu_torch.utils import profiling
        with tempfile.TemporaryDirectory(prefix="nimrud_bench_") as out:
            self.sync()
            with profiling.trace(out):
                for step in steps:
                    step()
                self.sync()
            return trace_summary(profiling.trace_events(out), len(steps))

    def roofline(self, model, staged, trace):
        """The byte model of a staged step (``workload.roofline_payload``),
        with its rates over the traced window where there is one."""
        from nimrud_tpu_torch.utils import workload
        roof = workload.roofline_payload(model, staged)
        if trace is None:
            return roof
        return workload.roofline_rates(roof, trace["window_ms_per_step"],
                                       self.device_name)

    def kernel_ms(self, fn, repeat=3):
        """Milliseconds a call of ``fn`` after a warm-up: CUDA events over
        ``repeat`` calls on the card, the host clock on the CPU."""
        fn()
        if not self.cuda:
            _, s = self.seconds(lambda: [fn() for _ in range(repeat)])
            return 1e3 * s / repeat
        import torch
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn()
        stop.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(stop) / repeat

    def reset_peak(self):
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_gib(self):
        """Peak device memory since :meth:`reset_peak` (None on the CPU)."""
        if not self.cuda:
            return None
        import torch
        return torch.cuda.max_memory_allocated(self.device) / 2**30

    def emit(self, result):
        """Print the stage's JSON line: ``result`` with the stage's name,
        device, points, total launches and wall time."""
        line = {"stage": self.name, "device": self.device_name,
                "n_points": self.n_points, **result,
                "launches_total": {k: v for k, v in launches().items() if v},
                "stage_wall_s": time.perf_counter() - self.t0}
        print(json.dumps(line), flush=True)
        return line


def _on_host(out):
    """``out`` (a tensor, or tuples and dicts of them) on the host."""
    if isinstance(out, tuple):
        return tuple(_on_host(v) for v in out)
    if isinstance(out, dict):
        return {k: _on_host(v) for k, v in out.items()}
    return out.cpu()


def counters(diags):
    """Overflow counters summed over the steps' diagnostics dicts, and
    whether all are zero."""
    total = {}
    for diag in diags:
        for key, value in diag.items():
            total[key] = total.get(key, 0) + int(value)
    return {"overflow_counters": total,
            "counters_all_zero": all(v == 0 for v in total.values())}


def accuracy(labels_dev, truth, rows=slice(None)):
    """Share of ``labels_dev[rows]`` (labels in caller order, a tensor)
    equal to ``truth[rows]``."""
    got = labels_dev[:len(truth)].cpu().numpy()
    return float((got[rows] == truth[rows]).mean())
