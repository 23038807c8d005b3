"""
One run of one cell: set-up, the measured window, the traced segment
(``trace``), the reference's check, and the result line.

Set-up makes everything from the seed: the labelled scan, the served
clouds and, where the traffic brings them, their per-point attribute
columns (the traffic's generator), the classifier state (the
reference's features, in the configuration's layout, of a sample of the
scan; a ridge fit or the forest's growth, ``reference``), the program's
model with that state installed, the designated map's handle, and
``warmup`` served clouds.  ``setup_s`` is
the process's start to the window's first cloud less the seconds of the
classifier state's making and of the host probe: the program's part.

The window is the traffic's loop (``perfbench/loops/``) over the pool.
A cloud's time runs from its arrival through ``stage`` (with its
attribute columns, where it has them), ``predict_staged`` (labels,
probabilities, overflow counters) and the copy of all three to the
host.  A cloud that raises, or whose counters
are not all zero, is counted in ``failed``.

The host probe times a fixed piece of single-threaded host work before
set-up and at the end of the run (the result line's ``host`` key), for
reading a run's speed against its host's.

A traced run (``trace``) times ``stage`` and ``predict_staged`` apart in
its window (a synchronize between them), then serves ``trace_clouds``
more under ``torch.profiler``, and, for a forest, times the walk alone.

Then the program is freed, and the reference computes, for every
served cloud, its probabilities at ``check_rows`` sampled points
(``core.compare``).
"""

import contextlib
import gc
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.core import compare, scene
from perfbench.core import trace as tracing
from perfbench.reference import features as rfeat
from perfbench.reference import forest as rforest
from perfbench.reference import linear as rlinear

WALK_REPEATS = 5
COUNTERS = ("vox_dropped", "dropped_query", "dropped_search",
            "interp_dropped", "dropped_candidates")   # predict_staged's


def note(msg):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def power_limit():
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


class Setup:
    """Everything a run serves, made from its seed."""

    def __init__(self, cell, seed, device):
        cfg, spec = cell.config, cell.traffic
        self.device = torch.device(device)
        self.bands = [tuple(b) for b in cfg["bands"]]
        self.lo, self.hi = (np.asarray(b, np.float32)
                            for b in cfg["site_bounds"])
        self.cfg, self.spec = cfg, spec
        self.traffic = scene.make_traffic(spec, seed, self.lo, self.hi)
        n = int(spec["points"])
        rows_rng = scene.rng(seed, scene.CHECK_ROWS)
        rows = int(spec["check_rows"])
        self.rows = [np.sort(rows_rng.choice(n, rows, replace=False))
                     for _ in self.traffic.pool]
        start = time.perf_counter()
        self._fit_classifier(seed)
        self.state_s = time.perf_counter() - start

    def search_attributes(self, k=None):
        """The attribute columns of the search cloud of pool cloud ``k``
        (of the labelled scan for None): the designated map's are the
        labelled scan's; None without attributes."""
        t = self.traffic
        if t.attributes is None:
            return None
        fit, pool = t.attributes
        return fit if k is None or t.search is not None else pool[k]

    def ref_scene(self, points, attributes=None):
        """The reference's view of a served cloud (on the device), with
        its search cloud's ``attributes``."""
        t = self.traffic
        search = None if t.search is None else \
            torch.from_numpy(t.search).to(self.device)
        if attributes is not None:
            attributes = torch.from_numpy(attributes).to(self.device)
        return rfeat.Scene(torch.from_numpy(points).to(self.device), search,
                           self.bands, self.lo, self.hi, t.self_search,
                           self.cfg["control_frame_m"], self.cfg["kind"],
                           attributes)

    def _fit_classifier(self, seed):
        fit = self.cfg["classifier_fit"]
        points, labels = self.traffic.fit
        rows = np.sort(scene.rng(seed, scene.FIT_ROWS).choice(
            len(points), int(fit["sample"]), replace=False))
        ref = self.ref_scene(points, self.search_attributes())
        feats = ref.features(torch.from_numpy(rows).to(self.device))[0]
        feats = feats[:len(rows)]
        labels = labels[rows]
        del ref
        kind = self.cfg["classifier"]
        if kind == "linear":
            state = rlinear.fit(feats, labels, int(labels.max()) + 1,
                                float(fit["ridge"]))
            self.state = state
            self.ref_proba = lambda f, p="float64": rlinear.proba(state, f, p)
        elif kind == "rpte":
            tables, depth, _ = rforest.grow(
                feats.cpu().numpy(), labels, int(fit["n_estimators"]),
                float(fit["impurity"]), int(fit["min_obs"]),
                int(fit["max_depth"]),
                int(scene.rng(seed, scene.FOREST).integers(2 ** 32)))
            self.state = {"tables": tables, "depth": depth,
                          "d_func": fit["d_func"]}
            self.ref_proba = lambda f, p="float64": rforest.proba(tables, f,
                                                                   p)
        else:
            raise ValueError(f"unknown classifier {kind!r}")

    def program(self):
        """The program's model with the state installed (its serving
        sized on the labelled scan, and its attribute columns where the
        traffic has them), and the designated map's handle (or None)."""
        from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
        from nimrud_tpu_torch.learning.rpt import RPTEnsemble
        from nimrud_tpu_torch.pipeline import GeometryClassifier

        cfg = self.cfg
        model = GeometryClassifier(
            [(e, (r,)) for e, r in self.bands], kind=cfg["kind"],
            classifier="linear", transfer_dtype=cfg["transfer_dtype"],
            backend=cfg["backend"], precision=cfg["precision"],
            bounds=(self.lo, self.hi), trim_entries=cfg["trim_entries"],
            device=self.device)
        if cfg["classifier"] == "linear":
            s = self.state
            clf = SoftmaxClassifier.from_state(s["w"], s["b"], s["mean"],
                                               s["scale"], self.device)
        else:
            s = self.state
            clf = RPTEnsemble.from_tables(s["tables"], s["depth"],
                                          s["d_func"], self.device)
        columns = self.search_attributes()
        kw = {} if columns is None else {"attributes": columns}
        model.install_classifier(clf, self.traffic.fit[0], **kw)
        handle = None
        if self.traffic.search is not None:
            handle = model.stage_search(self.traffic.search, **kw)
        return model, handle

    def stage_kw(self):
        """``stage``'s attribute argument a pooled cloud, by the cloud's
        id (none for a designated map's clouds, whose handle holds the
        map's)."""
        t = self.traffic
        if t.attributes is None or t.search is not None:
            return {}
        return {id(c): {"attributes": a}
                for c, a in zip(t.pool, t.attributes[1])}


class Server:
    """The timed path: one cloud from arrival to its answers on the
    host.  ``stage_kw``: ``stage``'s further arguments by the served
    cloud's id (``Setup.stage_kw``)."""

    def __init__(self, model, handle, device, stage_kw=None):
        self.model, self.handle = model, handle
        self.stage_kw = stage_kw or {}
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def step(self, cloud, split=False, annotate=False):
        """(labels, probabilities, counters) on the host and the seconds
        of (stage, predict, whole); ``split`` synchronizes after each
        part, ``annotate`` marks the parts for the profiler."""
        rng = torch.profiler.record_function if annotate \
            else (lambda name: contextlib.nullcontext())
        start = time.perf_counter()
        with rng("perfbench.stage"):
            if self.handle is None:
                staged = self.model.stage(cloud,
                                          **self.stage_kw.get(id(cloud), {}))
            else:
                staged = self.model.stage(cloud, staged_search=self.handle)
            if split:
                self.sync()
        mid = time.perf_counter()
        with rng("perfbench.predict"):
            labels, proba, diag = self.model.predict_staged(
                staged, with_proba=True, with_diag=True)
            if split:
                self.sync()
        end = time.perf_counter()
        with rng("perfbench.download"):
            counters = torch.stack([diag[k] for k in COUNTERS]).cpu()
            labels, proba = labels.cpu(), proba.cpu()
        done = time.perf_counter()
        return (labels, proba, counters), (mid - start, end - mid,
                                           done - start)


PROBE_ROWS, PROBE_REPEATS = 2 ** 20, 3


def host_probe():
    """Milliseconds of a fixed piece of single-threaded host work: the
    sort of a fixed array of 2**20 doubles, the median of three."""
    values = np.random.default_rng(0).random(PROBE_ROWS)
    times = []
    for _ in range(PROBE_REPEATS):
        start = time.perf_counter()
        np.sort(values, kind="quicksort")
        times.append(1e3 * (time.perf_counter() - start))
    return statistics.median(times)


def _p95(values):
    if len(values) < 2:
        return float("inf")
    return statistics.quantiles(values, n=20)[18]


def _profile(server, clouds):
    """Serve ``clouds`` under ``torch.profiler``; the trace's device and
    host events and the segment's (lo_us, hi_us)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    server.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("perfbench.segment"):
            for cloud in clouds:
                server.step(cloud, annotate=True)
            server.sync()
    folder = tempfile.mkdtemp(prefix="perfbench_trace_")
    try:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        events = tracing.load(path)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    host = tracing.host_events(events)
    segment = [(lo, hi) for name, lo, hi, _ in host
               if name == "perfbench.segment"]
    lo, hi = segment[0]
    device = [e for e in tracing.device_events(events)
              if e[2] > lo and e[1] < hi]
    return {"device": device, "host": host, "window_us": (lo, hi),
            "clouds": len(clouds)}


def _walk_ms(model, cloud, device, attributes=None):
    """Milliseconds of the forest walk alone on a served cloud's feature
    rows (``attributes``: its columns, for a layout that takes them):
    CUDA events around ``WALK_REPEATS`` calls."""
    kw = {} if attributes is None else {"attributes": attributes}
    feats = model.extract_device(cloud, **kw)
    walk = model.classifier.proba_device
    walk(feats)
    if torch.device(device).type != "cuda":
        start = time.perf_counter()
        for _ in range(WALK_REPEATS):
            walk(feats)
        return 1e3 * (time.perf_counter() - start) / WALK_REPEATS
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(WALK_REPEATS):
        walk(feats)
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / WALK_REPEATS


def run(cell, seed, seconds, trace, device="cuda", t0=None, control=False,
        fault=None):
    """One run; returns (result line dict without ``checks``, checks
    dict, records).  ``t0``: the process's start on ``time.perf_counter``.
    ``control``: also read the lower-precision control (the reference in
    TF32 in the program's place, on the same sampled points) into
    ``records["control"]``; the program's numbers are
    ``records["numbers"]``.  ``fault``: a fault of ``perfbench.faults``
    planted in the program for the whole run."""
    if fault is not None:
        from perfbench import faults

        with faults.planted(fault, cell.config):
            return run(cell, seed, seconds, trace, device, t0, control)
    t0 = time.perf_counter() if t0 is None else t0
    probe_start = time.perf_counter()
    probe = [host_probe()]
    probe_s = time.perf_counter() - probe_start
    cuda = torch.device(device).type == "cuda"
    card = power_limit() if cuda else None
    if card:
        note(f"card: {card}")
    setup = Setup(cell, seed, device)
    pool = setup.traffic.pool
    n = int(setup.spec["points"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model, handle = setup.program()
    server = Server(model, handle, device, setup.stage_kw())
    for k in range(int(setup.spec["warmup"])):
        server.step(pool[k % len(pool)], split=trace)
    server.sync()
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- the window --------------------------------------------------------
    served = {}
    lat, parts = [], []
    tally = {"attempted": 0, "failed": 0}

    def done(k, latency, outcome, error):
        tally["attempted"] += 1
        lat.append(latency)
        if error is not None:
            tally["failed"] += 1
            note(f"cloud {tally['attempted']} raised: {error}")
            return
        (labels, proba, counters), times = outcome
        if bool(counters.any()):
            tally["failed"] += 1
            note(f"cloud {tally['attempted']}: overflow counters "
                 f"{dict(zip(COUNTERS, counters.tolist()))}")
        rows = torch.from_numpy(setup.rows[k])
        served.setdefault(k, []).append((labels[rows], proba[rows]))
        parts.append(times)

    from perfbench.core import cell as cellmod

    serve = cellmod.loop(setup.spec["loop"])
    begin = time.perf_counter()
    setup_s = begin - t0 - setup.state_s - probe_s
    window_s = serve(lambda cloud: server.step(cloud, split=trace), pool,
                     setup.spec, seconds, done)
    attempted, failed = tally["attempted"], tally["failed"]
    points = n * len(parts)
    quarters = [float(statistics.median(q)) if len(q) else None
                for q in np.array_split(np.asarray(lat), 4)]
    note(f"latency median by quarter of the window (s): {quarters}")
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0

    # -- the traced segment ------------------------------------------------
    records = {"clouds": [{"stage_ms": 1e3 * s, "predict_ms": 1e3 * p}
                          for s, p, _ in parts] if trace else [],
               "points": n, "classifier": {"kind": setup.cfg["classifier"]}}
    traced = []
    if trace:
        traced = [(attempted + j) % len(pool)
                  for j in range(int(setup.spec["trace_clouds"]))]
        if cuda:
            records["trace"] = _profile(server, [pool[k] for k in traced])
        if setup.cfg["classifier"] == "rpte":
            records["classifier"]["walk_ms"] = _walk_ms(
                model, pool[0], device, setup.search_attributes(0))

    del server, model, handle
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------
    gaps, control_gaps, tied = [], [], []
    work = {"pairs": [], "voxels": []}
    layout_work = []
    for k in sorted(set(served) | set(traced)):
        ref = setup.ref_scene(pool[k], setup.search_attributes(k))
        rows = torch.from_numpy(setup.rows[k]).to(setup.device)
        if k in traced:
            scale = n / len(rows)
            work["pairs"].append([c * scale for c in ref.pair_counts(rows)])
            work["voxels"].append(ref.voxel_counts)
            layout_work.append(ref.layout_work())
        if k not in served:
            continue
        ties = ref.tied_rows(rows)
        if ties is not None:
            tied.append(ties * len(served[k]))
        feats, owner = ref.features(rows)
        ref_p = setup.ref_proba(feats)
        for labels, proba in served[k]:
            gaps.append(compare.point_gaps(
                proba.to(setup.device), labels.to(setup.device), ref_p,
                owner, len(rows)).cpu())
        if control:
            low = setup.ref_proba(ref.features(rows, "tf32")[0][:len(rows)],
                                  "tf32")
            control_gaps.append(compare.point_gaps(
                low, low.argmax(1), ref_p, owner, len(rows)).cpu())
        del ref
    miss_gap = float(setup.cfg["miss_gap"])
    nums = compare.numbers(gaps, miss_gap)
    if tied:
        nums["interp_tie_points"] = sum(tied)
    records["numbers"] = nums
    if control:
        records["control"] = compare.numbers(control_gaps, miss_gap)
    if work["pairs"]:
        records["work"] = {
            "points": n,
            "pairs": np.mean(work["pairs"], axis=0).tolist(),
            "voxels": np.mean(work["voxels"], axis=0).tolist()}
        for key in layout_work[0]:
            records["work"][key] = np.mean([w[key] for w in layout_work],
                                           axis=0).tolist()

    checks = {"failed_clouds": {"value": failed, "limit": 0}}
    for name, limit in setup.cfg["checks"].items():
        checks[name] = {"value": nums[name], "limit": limit}
    correct = nums["points"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    note(f"compared {nums['points']} points of {len(gaps)} served clouds: "
         f"gap_median {nums['gap_median']!r}, miss_share (gap > {miss_gap!r}) "
         f"{nums['miss_share']!r}, gap_max {nums['gap_max']!r}")
    probe.append(host_probe())
    host = {"probe_ms": probe}
    note(f"host probe (ms, before set-up and at the end): {probe}")

    e2e = {"setup_s": setup_s, "points_per_s": points / window_s,
           "cloud_p95_ms": 1e3 * _p95(lat), "peak_gib": peak_window / 2 ** 30}
    metrics = {}
    for m in cell.end_to_end:
        metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(peak_setup, peak_window))}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev,
            "host": host}
    if card:
        dev["card"] = card
    if trace:
        metrics.clear()
        for m in cell.per_layer:
            value = cellmod.metric_reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = records.get("trace")
        if tr is not None:
            lo, hi = tr["window_us"]
            dev["busy_s"] = tracing.busy_us(tr["device"]) / 1e6
            dev["window_s"] = (hi - lo) / 1e6
            line["breakdown"] = {
                "device_ops": tracing.op_table(tr["device"]),
                "idle_gaps": tracing.idle_gaps(tr["device"], tr["host"],
                                               tr["window_us"])}
    note(f"window {window_s:.3f} s, {attempted} clouds, {failed} failed, "
         f"set-up {setup_s:.3f} s (and {setup.state_s:.3f} s making the "
         f"classifier state)")
    return line, checks, records
