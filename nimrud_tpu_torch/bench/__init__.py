"""
The benchmark of the port (port of the reference's ``bench.py``): end-to-end
multiscale feature extraction and classification throughput on one card.

    python -m nimrud_tpu_torch.bench [--points N] [--device D]
    nimrud-torch bench [--points N] [--device D]

Four stages, in order, each in its own process
(``python -m nimrud_tpu_torch.bench.<stage>``), each printing one JSON
line:

  1. ``headline`` -- the 1M-point x 3-scale serving step on the packed
     backend (``bench/headline.py``);
  2. ``designated_search_stream`` -- a jittering stream served against one
     staged search map (``bench/designated.py``);
  3. ``large_scale_10m`` -- the 10M-point tile in entry chunks, with
     held-out accuracy (``bench/large.py``);
  4. ``rpte_serving`` -- the random-projection tree ensemble in the serving
     step (``bench/rpte.py``).

A global deadline (``NIMRUD_BENCH_DEADLINE_SEC``, default 1500 s) bounds
the run: each stage gets the smaller of its cap and the time left, and a
stage whose minimum no longer fits is recorded as ``{"skipped":
"deadline"}``; ``NIMRUD_BENCH_SKIP_DESIGNATED``, ``_LARGE`` and ``_RPTE``
skip a stage (``{"skipped": "env"}``).  A stage killed at its time limit
after printing its line is still harvested (with an ``orchestrator_note``).
``--points`` reaches the 1M stages; the 10M stage keeps its 10M.
``--device`` (default ``cuda``) reaches every stage.

Prints one JSON line: ``metric``, ``value`` (the headline's points per
second), ``unit``, ``vs_baseline`` (against the reference's CPU pipeline,
about 5,000 points per second a scale on one core, so 5000 / 3 at three
scales) and ``detail`` with each stage's line and the budget.  Exits 1
when a stage that ran has an error (a non-zero exit, or no line); the
line is printed all the same.

Not ported from the reference: its backend fallback loop, the exceptions
it folds into fields, the fall back to another stage's rate when the
headline fails, its committed TPU runs (``BENCH_VARIANTS.json``,
``BENCH_DENSITY.json``) and its v5p projection.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from nimrud_tpu_torch.bench._stage import BASELINE_PTS_PER_SEC

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DEADLINE = 1500.0
MARGIN = 20.0                      # the parent's assembly and print

# (key, module, cap_sec, min_sec, skip_env, takes --points)
STAGES = (
    ("headline", "headline", 600, 90, None, True),
    ("designated_search_stream", "designated", 400, 60,
     "NIMRUD_BENCH_SKIP_DESIGNATED", True),
    ("large_scale_10m", "large", 600, 90, "NIMRUD_BENCH_SKIP_LARGE", False),
    ("rpte_serving", "rpte", 400, 60, "NIMRUD_BENCH_SKIP_RPTE", True),
)


def _text(maybe_bytes):
    if isinstance(maybe_bytes, bytes):
        return maybe_bytes.decode("utf-8", "replace")
    return maybe_bytes or ""


def _last_json_line(text):
    """The last parseable ``{...}`` line of ``text`` (a killed child can
    leave a partial line after a complete one), or None."""
    for line in reversed(_text(text).strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _run_stage(module, args, timeout):
    """Run one stage's process; its JSON line, with an ``error`` where it
    exited non-zero or printed none."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", f"nimrud_tpu_torch.bench.{module}", *args]
    note = None
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=REPO)
        out, err, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as exc:
        # a stage that printed its line, then hung, still yields it
        out, err, rc = _text(exc.stdout), _text(exc.stderr), None
        note = f"killed at stage timeout {timeout:.0f}s"
    sys.stderr.write(_text(err))
    result = _last_json_line(out)
    if rc not in (0, None) or result is None:
        tail = _text(err).strip()[-600:] or "no output"
        reason = f"rc={rc}" if rc not in (0, None) else (note or "no line")
        return {**(result or {}), "error": f"{reason}: {tail}"}
    if note:
        result["orchestrator_note"] = note
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nimrud_tpu_torch.bench",
        description="end-to-end serving benchmark of nimrud_tpu_torch")
    parser.add_argument("--points", type=int, default=None,
                        help="cloud size of the 1M stages (default 1M)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every stage (default cuda)")
    args = parser.parse_args(argv)
    deadline = float(os.environ.get("NIMRUD_BENCH_DEADLINE_SEC",
                                    DEFAULT_DEADLINE))
    t0 = time.monotonic()
    results, walls = {}, {}
    for key, module, cap, min_sec, skip_env, takes_points in STAGES:
        if skip_env and os.environ.get(skip_env):
            results[key] = {"skipped": "env"}
            continue
        left = deadline - (time.monotonic() - t0) - MARGIN
        if left < min_sec:
            results[key] = {"skipped": "deadline", "remaining_sec": left}
            continue
        stage_args = ["--device", args.device]
        if takes_points and args.points:
            stage_args += ["--points", str(args.points)]
        start = time.monotonic()
        results[key] = _run_stage(module, stage_args, min(cap, left))
        walls[key] = time.monotonic() - start

    head = results["headline"]
    value = head.get("value")
    print(json.dumps({
        "metric": head.get("metric", "headline stage: no result"),
        "value": value,
        "unit": "points/sec",
        "vs_baseline": None if value is None
        else value / BASELINE_PTS_PER_SEC,
        "detail": {**results, "budget": {
            "deadline_sec": deadline,
            "elapsed_sec": time.monotonic() - t0,
            "stage_walls_sec": walls}},
    }), flush=True)
    return 1 if any("error" in r for r in results.values()) else 0
