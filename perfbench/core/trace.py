"""
Reading a ``torch.profiler`` chrome trace: frozen copies of
``nimrud_tpu_torch.utils.profiling.device_events``,
``device_track_stats`` and ``device_op_table``, plus the idle gaps
named by what the host was doing.

The device events are the complete (``ph == "X"``) events of category
``kernel``, ``gpu_memcpy`` or ``gpu_memset``.  The host's events are the
harness's own ranges (``perfbench.*``, category ``user_annotation``) and
the operators beneath them (``cpu_op``).
"""

import bisect
import collections
import gzip
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op")


def load(path):
    """Every event of a chrome trace file (``.json`` or ``.json.gz``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as handle:
        events = json.load(handle)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def device_events(events):
    """(name, start_us, end_us) of the device's events, by start."""
    return sorted(((e.get("name", ""), float(e["ts"]),
                    float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATEGORIES),
                  key=lambda e: (e[1], e[2]))


def host_events(events):
    """(name, start_us, end_us, category) of the host's ranges."""
    return [(e.get("name", ""), float(e["ts"]),
             float(e["ts"]) + float(e.get("dur", 0.0)), e.get("cat"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATEGORIES]


def busy_intervals(device):
    """The union of the device events' intervals, as sorted (lo, hi)."""
    merged = []
    for _, lo, hi in device:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [tuple(m) for m in merged]


def busy_us(device):
    """Length of the union of the device events' intervals: time in which
    some operation ran, overlapping streams counted once."""
    return sum(hi - lo for lo, hi in busy_intervals(device))


def short_name(name, width=160):
    """A kernel's name without its trailing parameter list (a bracket
    after a space, as in ``Memcpy DtoH (Device -> Pageable)``, stays),
    cut to ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if i > 0 and name[i - 1] != " ":
                    name = name[:i]
                break
    return name[:width]


def op_table(device, top=10):
    """Device time by operation (:func:`short_name`): ``[name, seconds]``
    rows, largest first."""
    total = collections.Counter()
    for name, lo, hi in device:
        total[short_name(name)] += hi - lo
    return [[name, us / 1e6] for name, us in total.most_common(top)]


def _innermost(spans, mid):
    """Name of the latest-started span of ``spans`` (sorted (start, end,
    name) rows) still open at ``mid``, or None."""
    i = bisect.bisect_right(spans, (mid, float("inf"), "")) - 1
    while i >= 0:
        lo, hi, name = spans[i]
        if hi > mid:
            return name
        i -= 1
    return None


def idle_gaps(device, host, window, top=10):
    """The device's idle time inside ``window`` (lo_us, hi_us), summed by
    what the host was doing at each gap's middle: the innermost harness
    range and the innermost operator open there
    (``"perfbench.stage/aten::copy_"``).  ``[name, seconds]`` rows,
    largest first."""
    lo_w, hi_w = window
    ranges = sorted((lo, hi, n) for n, lo, hi, c in host
                    if c == "user_annotation" and n.startswith("perfbench."))
    ops = sorted((lo, hi, n) for n, lo, hi, c in host if c == "cpu_op")
    edges = [(lo_w, lo_w)] + busy_intervals(device) + [(hi_w, hi_w)]
    total = collections.Counter()
    for (_, end), (start, _) in zip(edges[:-1], edges[1:]):
        gap_lo, gap_hi = max(end, lo_w), min(start, hi_w)
        if gap_hi <= gap_lo:
            continue
        mid = 0.5 * (gap_lo + gap_hi)
        where = _innermost(ranges, mid) or "outside"
        op = _innermost(ops, mid)
        total[where + ("/" + op if op else "")] += gap_hi - gap_lo
    return [[name, us / 1e6] for name, us in total.most_common(top)]
