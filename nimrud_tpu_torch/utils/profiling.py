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

Spans and counters of the serving path (:func:`span`, :func:`count`,
:func:`collected`) record exactly while a ``torch.profiler`` session
records -- :func:`trace`, or any ``torch.profiler.profile`` around the
model -- and then only: the switch is the profiler itself.  Off, a span
reads one bool (torch's own flag) and does nothing else.  On, it opens a
``torch.profiler.record_function`` range (a ``user_annotation`` event of
the chrome trace, on the kernels' clock) and keeps a record in memory:
its name, its parent span's name, its scan id, its host start and end
and, on CUDA, the device milliseconds between two CUDA events recorded
on the current stream at entry and exit.  Counters add host ints and
device scalars to the innermost open span's scan, read only by
:func:`collected`.
"""

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import tempfile
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

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
    where CUDA is available.  The program's spans and counters record
    inside it (:func:`collected`).
    """
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


# -- spans and counters -------------------------------------------------------

#: span records kept in memory; past it a span still opens its profiler
#: range, and its record is counted in ``collected()["dropped"]``
SPAN_LIMIT = 65536


def _profiler_on():
    """Whether a ``torch.profiler`` session records: torch's own flag,
    read through ``getattr`` so that a torch without it turns the spans
    off rather than failing the program."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class _Record:
    """One span's record (:func:`collected` gives it as a dict)."""

    __slots__ = ("name", "parent", "scan", "device", "prefix", "start_ns",
                 "end_ns", "events")

    def __init__(self, name, parent, scan, device, prefix):
        self.name, self.parent, self.scan = name, parent, scan
        self.device, self.prefix = device, prefix
        self.start_ns = self.end_ns = None
        self.events = None

    def as_dict(self):
        host_ms = (self.end_ns - self.start_ns) / 1e6
        if self.events is not None:
            device_ms = self.events[0].elapsed_time(self.events[1])
        elif self.device is not None and self.device.type == "cpu":
            device_ms = host_ms        # the CPU's work runs on the host
        else:
            device_ms = None
        return {"name": self.name, "parent": self.parent, "scan": self.scan,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": host_ms, "device_ms": device_ms}


class Recorder:
    """The spans and counters of one process (the profiler is one a
    process): a bounded list of span records, the counters' totals a
    scan (host ints, and device scalars a device), and a stack of open
    spans a thread."""

    def __init__(self, limit=SPAN_LIMIT):
        self.limit = limit
        self.lock = threading.Lock()
        self.local = threading.local()
        self.scans = itertools.count(1)
        self.reset()

    def reset(self):
        with self.lock:
            self.records = []
            self.dropped = 0
            self.host_totals = collections.Counter()   # (name, scan)
            self.device_totals = {}                     # (name, scan, device)

    def stack(self):
        """This thread's open spans, innermost last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, record):
        """Buffer ``record``; False (and counted) past the limit."""
        with self.lock:
            if len(self.records) >= self.limit:
                self.dropped += 1
                return False
            self.records.append(record)
            return True

    def add(self, name, value, scan):
        with self.lock:
            if isinstance(value, torch.Tensor):
                key = (name, scan, value.device)
                total = self.device_totals.get(key)
                self.device_totals[key] = value if total is None \
                    else total + value
            else:
                self.host_totals[name, scan] += int(value)

    def collected(self):
        with self.lock:
            records = [r for r in self.records if r.end_ns is not None]
            by_scan = collections.Counter(self.host_totals)
            device_totals = dict(self.device_totals)
            dropped = self.dropped
        devices = {r.device for r in records if r.events is not None}
        devices |= {device for _, _, device in device_totals
                    if device.type == "cuda"}
        for device in devices:
            torch.cuda.synchronize(device)
        for device in {device for _, _, device in device_totals}:
            keys = [key for key in device_totals if key[2] == device]
            values = torch.stack([device_totals[key].reshape(())
                                  .to(torch.int64) for key in keys])
            for (name, scan, _), value in zip(keys, values.tolist()):
                by_scan[name, scan] += value
        scans, counters = {}, collections.Counter()
        for (name, scan), value in sorted(by_scan.items(),
                                          key=lambda kv: (kv[0][1], kv[0][0])):
            scans.setdefault(scan, {})[name] = value
            counters[name] += value
        return {"spans": [r.as_dict() for r in records],
                "counters": dict(counters), "scans": scans,
                "dropped": dropped}


_RECORDER = Recorder()


class _Span:
    """A span while the profiler records (:func:`span`)."""

    __slots__ = ("name", "device", "scan", "top", "prefix", "record",
                 "range")

    def __init__(self, name, device, scan, top, prefix):
        self.name, self.device, self.scan, self.top = name, device, scan, top
        self.prefix = prefix
        self.record = self.range = None

    def __enter__(self):
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        if parent is None and not self.top:
            return None
        name = self.name
        if parent is not None and name.startswith("."):
            name = parent.name + name
        scan = self.scan
        if scan is None:
            scan = parent.scan if parent is not None \
                else next(_RECORDER.scans)
        device = parent.device if self.device is None and parent is not None \
            else self.device
        if device is not None:
            device = torch.device(device)
        prefix = self.prefix
        if prefix is None:
            prefix = parent.prefix if parent is not None else ""
        record = _Record(name, None if parent is None else parent.name,
                         scan, device, prefix)
        self.range = torch.profiler.record_function(name)
        self.range.__enter__()
        if _RECORDER.keep(record) and device is not None \
                and device.type == "cuda":
            record.events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            record.events[0].record(torch.cuda.current_stream(device))
        record.start_ns = time.perf_counter_ns()
        stack.append(record)
        self.record = record
        return record

    def __exit__(self, *exc):
        record = self.record
        if record is None:
            return False
        _RECORDER.stack().pop()
        if record.events is not None:
            record.events[1].record(torch.cuda.current_stream(record.device))
        record.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name, device=None, scan=None, top=False, counters=None):
    """
    A span of the program: ``with profiling.span("nimrud.predict"):``.
    While no profiler session records it reads one bool and is a no-op;
    while one records it opens a ``record_function`` range and keeps a
    record (see the module's docstring).  ``with ... as record`` gives
    the record (its ``scan``), or None where nothing records.

    ``top``: the span records also where no span is open on this thread
    (the entry points: ``nimrud.stage``, ``nimrud.predict``,
    ``nimrud.size``); any other span records only inside one, so code
    that other paths share records nothing there.  A ``name`` that
    starts with ``.`` is its parent's name and it: code shared by
    several entry points names its own layer (``span(".plan")``) and the
    entry point's span gives the context (``nimrud.predict.plan``).
    ``scan``: the scan id (default the parent's, or a new one for a span
    with no parent).  ``device``: where the enclosed work runs (default
    the parent's): on CUDA the record times it with CUDA events, on the
    CPU its device time is its host time, with None it has no device
    time.  ``counters``: the prefix of the counters added inside the
    span (default the parent's, none at the top).
    """
    if not _profiler_on():
        return _OFF
    return _Span(name, device, scan, top, counters)


def recording():
    """Whether spans and counters record here: a profiler session
    records, and a span is open on this thread.  Guard the work of a
    counter's value with it."""
    return _profiler_on() and bool(_RECORDER.stack())


def count(name, value):
    """Add ``value`` (a host int, or a device scalar tensor kept on the
    device until :func:`collected`) to counter ``name``, with the
    innermost open span's counter prefix, of that span's scan, where
    :func:`recording`."""
    if recording():
        record = _RECORDER.stack()[-1]
        _RECORDER.add(record.prefix + name, value, record.scan)


def collected():
    """The spans and counters recorded so far in this process, after one
    synchronize of each device they timed on: ``{"spans": [{"name",
    "parent", "scan", "start_ns", "end_ns", "host_ms", "device_ms"},
    ...] (closed spans, by start), "counters": {name: int} (over every
    scan), "scans": {scan: {name: int}}, "dropped": spans past
    ``SPAN_LIMIT``}``.  Reading clears nothing (:func:`reset` does)."""
    return _RECORDER.collected()


def reset():
    """Forget every span and counter recorded so far."""
    _RECORDER.reset()
