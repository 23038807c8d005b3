#!/usr/bin/env python3
"""
Quickest proof that the PyTorch / CUDA port (``nimrud_tpu_torch``) runs
its main path on one NVIDIA GPU.  From the repository root:

    python3 chip_smoke.py

Phases, one line each (plus a kernel-build report):

1. card    -- nvidia-smi name and power limit, torch's device name.
2. build   -- nvcc builds csrc/packed_moments.cu for sm_90a; ptxas's
              registers / shared memory / spills.
3. kernel  -- the CUDA ``packed_moments`` against its plain PyTorch twin
              on the card, at the main path's shapes (serving: q_cap 512,
              band-1 capacity buckets; fit: q_cap 256): counts equal,
              moments within ``moment_tolerance``; CUDA-event times.
4. main    -- the headline workload: ``make_bench_cloud(1_000_000)``,
              ``make_bench_model``, ``fit(sample=100_000)``, then
              ``stage`` + ``predict_staged`` on three clouds (seeds 0, 1,
              2).  All overflow counters 0, the kernel launched in fit
              and in serving, accuracy > 0.8; per-step host time ending
              in ``synchronize``; peak device memory.
5. e2e     -- a 100k-point scene served on the card and, with the same
              model, on the CPU (plain twin): labels agree except at
              near-ties (top-two probability gap < 1e-4), at most 0.1%.

With ``--profile DIR`` a profile phase runs after phase 4:
``torch.profiler`` over three steady serving steps of the fitted model
(clouds staged before the window), printing device busy time (the union
of kernel, memcpy and memset intervals), the traced wall time of
``predict_staged`` + synchronize, the device's idle share and the
largest kernels by device time; the chrome trace and the full kernel
table go to ``DIR``.

Then a JSON line with the kernel record and, last, the result line.
Any failure raises (exit code 1).  Without a CUDA device it exits with
code 2 and prints no result.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

N_POINTS = 1_000_000
FIT_SAMPLE = 100_000
E2E_POINTS = 100_000
TIE_GAP = 1e-4


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _events_ms(fn, repeat):
    import torch
    fn()                                              # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeat


def _kernel_phase(model, cloud, device):
    """Kernel vs plain at the shapes the main path gives the kernel."""
    import numpy as np
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import device_grid, packing, span_host, unique
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    problems = []
    # serving: band 1 (the pack grid) at q_cap 512, split capacities
    specs = model._fused_band_specs(cloud)
    band = specs[0]
    q_bucket = multiscale._pow2_bucket(len(cloud))
    quant, dequant = pipeline._quantize_upload(
        cloud, model.bounds[0], model.bounds[1], q_bucket, device)
    query = pipeline._dequantize(quant, dequant)
    valid = torch.arange(q_bucket, device=device) < len(cloud)
    centers, mask, _ = pipeline._band_search_prep(query, valid, band)
    plan = device_grid._pack_plan(query, valid, band[1])
    spans = device_grid._band_spans(plan, centers, mask, band[1],
                                    presorted=True)
    buckets, _ = device_grid._bucket_problems(
        plan["q_t"], plan["centers"], spans["span_starts"],
        spans["span_lens"], device_grid._far_extended(spans["sorted_pts"]),
        band[5])
    problems += [("serve", b[:3], band[2]) for b in buckets]
    # fit: band 1 at q_cap 256, one capacity (extract_scaleset_fused)
    edge, radii = model.scaleset[0]
    lo = np.asarray(model.bounds[0], np.float64)
    hi = np.asarray(model.bounds[1], np.float64)
    spec = device_grid.with_entry_estimate(device_grid.make_spec(
        lo, hi, max(radii), n_query=q_bucket, m=model.tile_m, q_cap=256,
        voxel_edge=edge, entry_batch=256, x_seg=32), cloud)
    cap = span_host.candidate_cap(
        cloud, multiscale._host_unique_voxels(cloud, edge,
                                              bounds=model.bounds), spec)
    query32 = torch.from_numpy(
        multiscale._pad_rows_f32(cloud, q_bucket)).to(device)
    vc, _, vm = unique.unique_voxels(
        query32, packing.GridSpec.fit_bounds(lo, hi, edge), valid=valid)
    prob = device_grid._span_problem(query32, valid, vc, vm, spec)
    buckets, _ = device_grid._bucket_problems(
        prob["q_t"], prob["centers"], prob["span_starts"],
        prob["span_lens"], device_grid._far_extended(prob["sorted_pts"]),
        int(cap))
    problems += [("fit", b[:3], radii) for b in buckets]

    rows, max_err = [], 0.0
    ms = {"serve": [0.0, 0.0], "fit": [0.0, 0.0]}
    for side, (q_t, cand_t, cen), rr in problems:
        got = pm.packed_moments(q_t, cand_t, cen, rr)
        torch.cuda.synchronize()
        ref = pm.packed_moments_plain(q_t, cand_t, cen, rr)
        counts = slice(0, None, 16)
        _check(torch.equal(got[..., counts], ref[..., counts]),
               f"{side} counts differ at {tuple(q_t.shape)}")
        err = (got - ref).abs()
        tol = pm.moment_tolerance(ref, cand_t, cen)
        _check(bool((err <= tol).all()),
               f"{side} moments outside tolerance at {tuple(q_t.shape)}")
        _check(bool(torch.isfinite(got).all()), "non-finite slabs")
        max_err = max(max_err, float(err.max()))
        k_ms = _events_ms(lambda: pm.packed_moments(q_t, cand_t, cen, rr),
                          5)
        p_ms = _events_ms(
            lambda: pm.packed_moments_plain(q_t, cand_t, cen, rr), 3)
        ms[side][0] += k_ms
        ms[side][1] += p_ms
        c_cap = cand_t.shape[1] // q_t.shape[0]
        rows.append(f"{side} E={q_t.shape[0]} q_cap={q_t.shape[2]} "
                    f"c_cap={c_cap} kernel {k_ms:.4f} ms plain "
                    f"{p_ms:.4f} ms max_abs_err {float(err.max()):.3g}")
    return rows, max_err, ms


def _profile_phase(model, out_dir):
    """Device busy time, idle share and kernel times of three steady
    serving steps, from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nimrud_tpu_torch.utils import workload

    os.makedirs(out_dir, exist_ok=True)
    staged = [model.stage(workload.make_bench_cloud(N_POINTS, seed=s)[0])
              for s in (3, 4, 5)]
    model.predict_staged(staged[0])                    # warm-up
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for st in staged:
            t0 = time.perf_counter()
            model.predict_staged(st)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
    trace = os.path.join(out_dir, "serving_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    _check(len(device) > 0, "the profiler traced no device work")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in device)
    busy_us, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy_us += cur_hi - cur_lo
            cur_lo = lo
        cur_hi = max(cur_hi, hi)
    busy_us += cur_hi - cur_lo
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += float(e["dur"]) / 1e3
        by_name[e["name"]][1] += 1
    table = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    n_steps = len(staged)
    with open(os.path.join(out_dir, "serving_kernels.txt"), "w") as f:
        for name, (ms, n) in table:
            f.write(f"{ms / n_steps:.4f} ms/step\t{n / n_steps:g} "
                    f"calls/step\t{name}\n")
    wall = sum(walls)
    print(f"[profile] {n_steps} steps: predict_staged + sync traced ms "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f"; device busy {busy_us / 1e3 / n_steps:.3f} ms/step; idle "
          f"share {1 - busy_us / 1e3 / wall:.4f}; "
          f"{len(device) / n_steps:g} device events/step", flush=True)
    for name, (ms, n) in table[:8]:
        print(f"[profile] {ms / n_steps:.4f} ms/step "
              f"({100 * ms / (busy_us / 1e3):.1f}% of busy), "
              f"{n / n_steps:g} calls/step: {name[:90]}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile three serving steps; write the "
                             "trace and kernel table to DIR")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    from nimrud_tpu_torch.pipeline import COUNTERS
    from nimrud_tpu_torch.utils import workload

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[card] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    _, report = pm.build()
    usage = [ln.split("info    :")[-1].strip() for ln in report.splitlines()
             if "Used" in ln or "spill" in ln]
    print(f"[build] {time.perf_counter() - t0:.2f} s; ptxas: "
          + " | ".join(usage), flush=True)

    cloud, labels = workload.make_bench_cloud(N_POINTS, seed=0)
    model = workload.make_bench_model(cloud, device=device)
    rows, max_err, kms = _kernel_phase(model, cloud, device)
    for row in rows:
        print(f"[kernel] {row}")
    print(f"[kernel] serving band-1 total: kernel {kms['serve'][0]:.4f} ms, "
          f"plain {kms['serve'][1]:.4f} ms; fit band-1 total: kernel "
          f"{kms['fit'][0]:.4f} ms, plain {kms['fit'][1]:.4f} ms", flush=True)

    # -- the main path, counted from zero ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    pm.packed_moments.launches = 0
    t0 = time.perf_counter()
    model.fit(cloud, labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = pm.packed_moments.launches
    steps, accs = [], []
    diags = []
    for seed in (0, 1, 2):
        c, lab = workload.make_bench_cloud(N_POINTS, seed=seed)
        t0 = time.perf_counter()
        staged = model.stage(c)
        t1 = time.perf_counter()
        out, diag = model.predict_staged(staged, with_diag=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.append((1e3 * (t2 - t0), 1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        diags.append({k: int(v) for k, v in diag.items()})
        accs.append(float((out.cpu().numpy() == lab).mean()))
    launches = pm.packed_moments.launches
    serve_launches = launches - fit_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] fit {fit_s:.3f} s ({fit_launches} kernel launches); "
          f"serve steps ms (total, stage, predict+sync): "
          + "; ".join(f"{t:.3f}, {s:.3f}, {p:.3f}" for t, s, p in steps)
          + f"; {serve_launches} serve launches; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; peak {peak_gb:.3f} GiB", flush=True)
    _check(fit_launches > 0, "the kernel did not run in fit")
    _check(serve_launches > 0, "the kernel did not run in serving")
    for d in diags:
        _check(all(d[k] == 0 for k in COUNTERS), f"overflow counters {d}")
    _check(all(a > 0.8 for a in accs), f"accuracy {accs}")
    if args.profile:
        _profile_phase(model, args.profile)

    # -- the same model on the CPU (plain twin) vs the card ------------------
    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    gpu = workload.make_bench_model(small, device=device)
    gpu.fit(small, small_labels, sample=E2E_POINTS // 2)
    clf = gpu.classifier
    cpu = workload.make_bench_model(small, device="cpu")
    cpu.install_classifier(SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu"), small)
    other, _ = workload.make_bench_cloud(E2E_POINTS, seed=1)
    g_lab, g_prob = gpu.predict_staged(gpu.stage(other), with_proba=True)
    t0 = time.perf_counter()
    c_lab = cpu.predict_staged(cpu.stage(other))
    cpu_s = time.perf_counter() - t0
    g_prob = g_prob.cpu()
    top2 = torch.sort(g_prob, dim=1).values[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = g_lab.cpu() != c_lab
    print(f"[e2e] {E2E_POINTS} points: {int(differ.sum())} labels differ "
          f"(card vs cpu), {int(near_tie.sum())} near-ties; cpu serve "
          f"{cpu_s:.2f} s", flush=True)
    _check(not bool((differ & ~near_tie).any()),
           "card and cpu labels differ away from near-ties")
    _check(int(differ.sum()) <= 0.001 * E2E_POINTS, "too many label flips")

    print(json.dumps({"kernels": [{
        "name": "packed_moments", "route": "cuda",
        "source": "nimrud_tpu_torch/csrc/packed_moments.cu",
        "replaces": "nimrud_tpu/ops/pallas/packed_kernel.py:236",
        "launches": launches, "max_abs_err": max_err,
        "ms": kms["serve"][0], "plain_ms": kms["serve"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
