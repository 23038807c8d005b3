"""
Profiling and throughput observability (port of
``nimrud_tpu/utils/profiling.py``).

  * :class:`RateTimer` -- structured points/sec reporting;
  * :func:`trace` -- a context manager around ``torch.profiler`` that
    writes a chrome trace (``*.trace.json.gz``, for Perfetto or
    ``chrome://tracing``) of the wrapped region;
  * :func:`device_track_stats` / :func:`device_op_table` -- parse such a
    trace into device busy time and a per-kernel table.

The device events of a ``torch.profiler`` chrome trace are its complete
(``ph == "X"``) events of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the host's operator and runtime events are left out.
"""

import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time

#: chrome-trace categories of the work the card ran
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class RateTimer:
    """Accumulates (points, seconds) and reports throughput."""

    def __init__(self, label="pipeline"):
        self.label = label
        self.points = 0
        self.seconds = 0.0
        self._started = None

    def __enter__(self):
        self._started = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._started
        self._started = None

    def add_points(self, n):
        self.points += int(n)
        return self

    @property
    def rate(self):
        return self.points / self.seconds if self.seconds else 0.0

    def report(self, printer=print):
        printer(json.dumps({
            "label": self.label,
            "points": self.points,
            "seconds": round(self.seconds, 4),
            "points_per_sec": round(self.rate, 1),
        }))
        return self


@contextlib.contextmanager
def trace(log_dir=None):
    """
    Trace the enclosed region, host and card, into
    ``<log_dir>/<time>.trace.json.gz`` (default directory
    ``nimrud_trace`` under the temporary directory):

        with profiling.trace("traces"):
            model.predict(cloud)

    Yields the ``torch.profiler.profile``.  The card's activity is traced
    where CUDA is available.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "nimrud_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    stamp = time.strftime("%Y%m%d_%H%M%S") + f"_{time.time_ns() % 10**9:09d}"
    prof.export_chrome_trace(os.path.join(log_dir, f"{stamp}.trace.json.gz"))


def trace_events(trace_path):
    """Every event of a chrome trace: ``trace_path`` is the file
    (``.json`` or ``.json.gz``), a directory, whose newest
    ``*.trace.json[.gz]`` (by name) is read, or the event list itself
    (so that one large trace is read once for the functions below)."""
    if isinstance(trace_path, list):
        return trace_path
    if os.path.isdir(trace_path):
        paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
                 for p in glob.glob(os.path.join(trace_path, "**", pattern),
                                    recursive=True)]
        if not paths:
            raise FileNotFoundError(f"no *.trace.json[.gz] under "
                                    f"{trace_path}")
        trace_path = max(paths, key=os.path.basename)
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as handle:
        events = json.load(handle)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def device_events(trace_path):
    """The device events (complete events of ``DEVICE_CATEGORIES``) of
    the trace :func:`trace_events` reads, as its event dicts.  Raises if
    it holds none, as a trace of the CPU alone does."""
    events = trace_events(trace_path)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise ValueError(
            "no device events in the trace; categories seen: "
            + ", ".join(sorted({str(e.get("cat")) for e in events})))
    return device


def device_op_table(trace_path, top=20):
    """Device time by kernel name: ``(total_ms, count, name)`` rows,
    largest first (``top`` of them; None: all)."""
    total = collections.Counter()
    count = collections.Counter()
    for e in device_events(trace_path):
        total[e.get("name", "")] += float(e.get("dur", 0.0))
        count[e.get("name", "")] += 1
    return [(round(us / 1e3, 3), count[name], name)
            for name, us in total.most_common(top)]


def device_track_stats(trace_path):
    """
    ``(busy_us, window_us)`` of the trace's device events: ``busy_us``
    the length of the union of their intervals, ``window_us`` first
    start to last end (gaps included).  On the TPU's one track of the
    reference no two operations overlap, and there the union is its sum
    of durations; kernels on several CUDA streams may overlap, and the
    union counts such time once.  Raises if the trace holds no device
    events.
    """
    spans = sorted((float(e["ts"]),
                    float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in device_events(trace_path))
    busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo = lo
        cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy, max(hi for _, hi in spans) - spans[0][0]
