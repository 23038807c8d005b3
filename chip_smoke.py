#!/usr/bin/env python3
"""
Quickest proof that the PyTorch / CUDA port (``nimrud_tpu_torch``) runs
its paths on one NVIDIA GPU.  From the repository root:

    python3 chip_smoke.py

Phases, one or more lines each:

1. card    -- nvidia-smi name and power limit, torch's device name.
2. build   -- one nvcc per kernel, all started together: csrc/
              packed_moments.cu, span_moments.cu, entry_moments.cu and
              forest_walk.cu for sm_90a; ptxas's registers / shared
              memory / spills per template instance (no kernel may
              spill) and, from ``cuobjdump -sass``, the HMMA
              (tensor-core) instructions of each instance: every moment
              kernel's must hold some (the 12 ``forest_walk_kernel``
              instances, one a padded row width, none; 43 instances
              of ``packed_moments``: 1-4 radii without and with the sazo
              fold, the attribute instances at 1-4 radii and 1, 4 or 6
              attribute slots, the chebyshev instances at 1, 4 or 6
              slots, and the ``exclude_radius`` instances of the
              euclidean families -- ``packed_excl_kernel`` at 1-4 radii
              without and with the sazo fold, ``packed_attr_excl_kernel``
              at 1-4 radii and 1, 4 or 6 slots; 8 of the two others: 1-4
              radii without and with the exclusion).
2b. native -- the C++ host runtime (``ops/native.py``, csrc/tilesort.cpp):
              its g++ build, then each of its eight functions against
              its NumPy twin on the 1M-point bench cloud, bit for bit,
              with both host times: ``quantize_u16`` (and on a cloud of
              exact half-step ties), ``minmax3``, ``tile_sort`` at
              factors 1 and 3 on band 0's serving grid, the tables of
              ``build_tiled_problem`` at band 0 (``fill_table``,
              ``mark_neighbors``, ``neighbor_rows``), ``voxel_unique``
              at the three band edges, ``parse_ascii`` of the cloud as
              CSV text.  Then ``stage`` of the packed model with
              ``impl="numpy"`` and native on the three clouds of phase
              4 (uploads equal), host ms to synchronize.
3. kernel  -- the CUDA ``packed_moments`` against its plain PyTorch twin
              on the card, at the packed path's shapes (serving: q_cap
              512, band-0 capacity buckets; fit: q_cap 256), at both
              precisions: counts equal, moments within
              ``moment_tolerance``; CUDA-event times (launches queued
              behind a spin kernel, so timed back to back), the pairs
              and the bound reckoned from the inputs
              (``packed_moments_work``),
              the share of the bound, the largest error as a share of
              its tolerance; the SM clock read right after.  Then its
              sazo instance on the serving buckets the same way (rows
              10 / 11 bit for bit: their tolerance is 0), its time
              beside the instance without the fold on the same inputs.
4. main    -- the packed path: ``make_bench_cloud(1_000_000)``,
              ``make_bench_model``, ``fit(sample=100_000)``, then
              ``stage`` + ``predict_staged`` on three clouds (seeds 0, 1,
              2).  All overflow counters 0, ``packed_moments`` launched
              in fit and in serving, accuracy > 0.8; per-step host time
              ending in ``synchronize``; peak device memory.
4b. designated -- designated-search streamed serving (the reference's
              ``scripts/bench_designated.py``): the fitted model's
              ``stage_search`` of the cloud, map overflow 0; the cloud
              and two 1 cm jitters of it (``default_rng(7)``) through
              ``predict_stream(..., staged_search=handle)``, counted
              from zero: only ``packed_moments`` launched (its launches
              a step printed), labels equal to the per-cloud
              ``stage(c, search=map)`` labels exactly, accuracy > 0.8,
              counters 0; the handle build time, each step's ms
              (staging + ``predict_staged`` to synchronize) and the
              stream's wall time per cloud against that loop's.  Then
              ``sazo`` and ``vector`` designated at 100k points
              (``vector`` with the bench attributes on the map), and
              ``minimal`` designated card against CPU at 100k (labels
              differ only at near-ties).
5. span    -- the span path: ``make_bench_model(backend="pallas")``
              serving the same three clouds with the packed model's
              classifier (``install_classifier``).  ``span_moments``
              launched and ``packed_moments`` not, counters 0, accuracy
              > 0.8, at most 0.01% of labels differ from the packed
              model's; per-step times, peak memory.  The flip witness:
              both backends' serving features on the same clouds, at
              every point whose labels or populations differ and at
              4096 sampled points a cloud, against a float64 oracle:
              populations equal up to the candidates within the f32
              rounding bound of r^2, the other features within their
              f32 rounding bounds where no candidate is that close.
              Then ``span_moments`` against its plain twin at the
              path's band-0 shapes, as in phase 3.
6. tiled   -- the tiled entry path, per band: ``build_tiled_problem``
              on the host (voxel centers as the search cloud, tile edge
              = radius, m = 3, entry batch 256),
              ``tiled_features(backend="pallas")`` on the card.  ``entry_moments`` launched, features finite,
              the population column equal to the packed extraction's
              for >= 99.9% of points; host and device time per band.
              Then ``entry_moments`` against its plain twin on band 0's
              first entry batch, with the valid share of its candidate
              slots and the k16 groups the kernel runs per entry.
6b. xla    -- the XLA candidate-table path (``backend="xla"``, no
              kernel): ``make_bench_model(cloud, backend="xla")`` fit
              (``sample=100_000``) and served on the three clouds of
              phase 4, counted from zero (no moment kernel may launch),
              counters 0, accuracy > 0.8; fit and step times, peak
              memory, each band's entries, batches and candidate lanes.
              The same model with the packed classifier: its labels
              against the packed step's (at most 0.01% differ), every
              difference held by the flip witness of phase 5 in the XLA
              plan's entry frames.  Card against CPU at 100k: labels
              differ only at near-ties.  Once each, counted from zero:
              ``sazo`` on ``backend="pallas"`` (XLA bands) at 100k,
              ``vector`` with 9 (the matmul interp) and 7 (the gather
              interp) attribute columns on the packed backend over the
              100k cloud's 50 m quadrant, an edge-0 model's
              ``predict_device`` (one band, r 0.5, the tiled method over
              the raw cloud; populations equal to the entry kernel's on
              its tiled problem), ``extract_scaleset_device`` with
              ``method="tiled"`` at 1M and ``"dense"`` at 16,000 points.
              Then band 0's tiled problem of phase 6 through
              ``tiled_features(backend="xla")`` beside ``"pallas"``
              (CUDA events), populations equal; the phase's wall time.
7. kinds   -- the other layouts on the packed path:
              ``make_bench_model(cloud, kind=k)``, fit
              (``sample=100_000``) and serve on the 1M-point clouds
              (``sazo`` and ``oriented`` the three clouds,
              ``geometric``, ``covariance`` and ``eigen`` one;
              ``vector`` three steps of its fit cloud, with the two
              attribute columns of the reference's
              ``scripts/bench_kinds.py``, ``make_bench_attributes``: the
              interp's capacities are sized on the fit cloud's raw
              density, which the other seeds exceed):
              counters 0 (``interp_dropped`` included), accuracy > 0.8,
              each kind's ``packed_moments`` instances launched in fit
              and in serving and no other kernel -- the sazo instance
              for ``sazo``, the attribute and chebyshev instances for
              ``vector``, the plain one for the others; fit and step
              times, peak memory.  Then the attribute and chebyshev
              instances against their plain twin at the vector path's
              band-0 shapes (the packed interp: q_cap 128, one radius =
              the 0.25 m edge, A = 2, its capacity buckets; the
              extraction: the serving plan's buckets, A = 2), as in
              phase 3, with each instance's launches a step and ptxas
              lines.
8. e2e     -- a 100k-point scene served by both backends on the card
              and, with the same classifier, on the CPU (plain twins):
              labels agree except at near-ties (top-two probability gap
              < 1e-4), at most 0.01%.  Then ``sazo``, ``oriented`` and
              ``vector`` (on its fit cloud) on the packed backend: each
              differing label has
              a near-tie, or the rounding witness (``_rounding_witness``:
              every feature of the card's and the CPU's rows within its
              stated f32 bound -- against a float64 oracle for the
              geometry layouts, the attribute-mean bound for ``vector``
              -- so only f32 rounding moved it; the largest difference
              as a share of its bound is printed), at most 0.01% of
              labels together; for ``oriented`` also the sign witness
              (``layouts.reconcile``: with the eigenvector signs turned
              to the CPU's and the vectors of nearly equal eigenvalues
              taken from it, the card's feature rows give the CPU's
              labels), at most 2% of labels.
9. exclude -- ``exclude_radius`` (0.1 m): the exclusion instances
              against their twins at the exclusion paths' band-0 shapes
              (``packed_moments`` on the fit band-0 inputs of
              ``extract_scaleset_fused``, q_cap 256, one capacity, with
              its sazo instance and its attribute instance at A = 2 on
              them; ``span_moments`` on the same band's spans;
              ``entry_moments`` on the tiled band 0's first batch), as
              in phase 3, each at 0.0 bit-equal to the same family
              without exclusion, and the share of band 0's pairs the
              exclusion removed (> 0).  Then the path at full width:
              ``make_bench_model(cloud, exclude_radius=0.1)``, fit
              (``sample=100_000``), ``predict`` (no overflow warning)
              and ``predict_device`` with its counters on the three
              clouds: counters 0, accuracy > 0.8, only
              ``packed_moments_excl`` launched, ``stage`` raises.  The
              span extraction (``backend="pallas"``), the tiled band 0,
              the ``sazo`` and ``vector`` extractions with the
              exclusion, each counted from zero: only their exclusion
              instance launched (and the interp's chebyshev one for
              ``vector``), populations equal to the packed path's for
              >= 99.9% of points.  Then card against CPU at 100k
              points: populations equal, every feature of 4096 sampled
              rows and of each differing label within its f32 bound of
              a float64 oracle without the excluded pairs
              (``_rounding_witness``), differing labels at near-ties or
              witnessed, at most 0.01%.
10. rpte   -- the reference's ``scripts/bench_rpte.py`` workload:
              ``make_bench_model(cloud, classifier="rpte")`` (10 trees,
              ``wmean``, seed 0), ``fit`` (``fit_device`` on a 100k
              sample) and serving the three clouds of phase 4, counted
              from zero: only ``packed_moments`` and ``forest_walk``
              launched, counters 0,
              accuracy > 0.8; fit seconds, step times, the forest's
              ``max_depth_``, the levels walked a step (``walk_depth_ +
              1``: one past the deepest split) and the
              levels the cloud's rows need, the walk alone timed on the served
              rows, peak memory.  Then the walk kernel
              (``csrc/forest_walk.cu``, ``_walk_phase``) against its
              plain twin on ``extract_device``'s rows of a served cloud,
              on the slot rows a serving step hands the classifier, and
              on drawn forests (``WALK_DRAWS``: depth 1-14, 4-100
              features, 2-20 classes, 1-100 trees, the register
              instances and the wide kernel, both decision functions, 1
              row and row counts off the 128-row block, walks cut
              short): a row may differ in a probability by
              more than ``WALK_PROBA_TOLERANCE`` or in its label only
              where the walk witness holds it near a split; a served
              scan launches it once an entry chunk plus once for the
              scatter's zero row, also counted as ``walk_launches`` in a
              traced scan (phase 4's linear scans launch it never); its
              time on the step's rows (CUDA events) beside its bound
              (``forest_walk_work``: the projections' operations or the
              bytes once, the tables' counted as the distinct rows the
              walk reads) and the plain twin's.  Then card against CPU at 100k
              (``_e2e_kind`` with the forest): differing labels at
              near-ties or held by the rounding witness, the card's
              label being the CPU walk's of the card's rows or held by
              the walk witness (``checks.walk_witness``: a node of the
              row's float64 path within the f32 rounding bound of its
              split), at most 0.01%.
11. large  -- the reference's ``scripts/bench_large.py`` workload:
              ``make_bench_cloud(10_000_000, seed=1)``, the bench model
              fit on ``cloud[:9_000_000:9]`` (``sample=100_000``),
              served in entry chunks at the default ``_CHUNK_SLOTS``
              (at least 2): e_cap, q_cap, the chunk and the chunks, the
              host sizing seconds, three steps counted from zero (only
              ``packed_moments``, its launches a step), counters 0,
              accuracy > 0.8 over the 10M points and held out on the
              last 1M, peak memory; ``packed_moments`` against its
              plain twin at band 0's capacity buckets of the first entry
              chunk, the chunk of the last live entry and the ragged
              last chunk (E and c_cap of each);
              then a second model with the same classifier and
              un-chunked slots: its peak memory, the served feature
              rows bit-equal to the chunked step's, labels equal,
              probabilities within ``checks.CHUNK_PROBA_TOLERANCE``
              (bit-equality printed).
12. knn    -- ``features.knn.knn_features`` (``minimal`` and ``eigen``,
              k 16, horizon 0.5 m: the bench's band-0 radius) and the
              kNN and radius searches (``ops.neighbors``, k_max 64) of
              ``make_bench_cloud(1_000_000)`` against itself, counted
              from zero (no moment kernel may launch): each timed to
              synchronize, with its entries, entry batches, sub-batches,
              compacted candidate width, pairs and peak memory; the
              radius search's overflowed share.  Then 2,000 queries
              against scipy's cKDTree in float64 (distances within 1e-4
              or the stated f32 bound of d2, indices equal except at
              distance ties, radius counts equal except at a candidate
              within the bound of r^2, the nearest k_max kept where a
              query overflows), and card against CPU at 100k points:
              counts equal, every differing index witnessed (its
              candidates' float64 d2 within twice the f32 bound).
13. host   -- the host-classifier route: ``sklearn``'s version or
              ``sklearn: not importable`` first; the bench model with a
              NumPy nearest-class-mean classifier (and ``rf``,
              ``n_estimators=10``, where sklearn imports), fit
              (``sample=100_000``) and ``predict_device`` on the three
              clouds of phase 4, counted from zero: only
              ``packed_moments`` launched, counters 0, accuracy > 0.8,
              ``stage`` raises, the labels the argmax of the float32
              cast of ``predict_proba`` on the model's own ``extract``
              rows; card against CPU at 100k, each differing label held
              by the rounding witness.  Then
              ``utils.memory.projected_fused_bytes`` beside the measured
              peaks of the 1M packed fit and serving steps and of the
              10M steps (chunked and un-chunked): the projection must
              not fall below any of them.
14. workflows -- the archive-to-labels path of the command line
              (``nimrud_tpu_torch.cli.main`` in process, ``--device
              cuda``, in a directory under the gitignored ``_build``):
              ``ingest`` of ``make_bench_cloud(1_000_000)`` and its
              labels as ``.npy``, ``info``; ``features --scales
              0.25:0.5 0.5:1.0 1.0:2.0 --kind minimal`` counted from
              zero (only ``packed_moments``, its launches printed), the
              stored rows bit-equal to a direct ``extract_scaleset`` of
              the archive's cloud with its counters 0;
              ``auto_partition_population``'s decision at 1M (None: one
              piece); the same with ``--partition-max 65536`` (no moment
              kernel: edge-0 bands on XLA sums; the partitions a band;
              populations equal to the fused run's for >= 99.9%);
              ``train`` with ``rpte`` and ``linear`` (seed 0, 50,000
              rows a class; validation accuracy > 0.8, fit and apply
              seconds), ``evaluate`` (accuracy > 0.8), ``export`` to
              csv, ply and las with probabilities, read back (1M rows,
              the las classification the labels); matplotlib's version
              or ``matplotlib: not importable``, and ``confusion_plot``
              where it imports.  Then ``sweep_extraction`` on 200k
              points (tiled and fused, m 2 and 3): no error row, the
              fused rows' ``packed_moments`` launches, each row's entry
              fill equal to ``plan_report``'s, the best run's trace
              through ``utils.profiling`` (busy within its window, the
              top kernels; ``packed_moments`` among them where a fused
              row is best).
15. multichip -- the multi-device layer (``nimrud_tpu_torch.parallel``)
              on a (2, 2) mesh whose four entries are the one card, and
              the default mesh ``make_mesh_2d((n, 1))`` over the visible
              cards: ``shard_cloud_2d`` of the 1M bench cloud (rows a
              shard, halo_x, halo_y, host seconds); ``predict_multichip``
              of phase 4's fitted packed bench model on its three clouds,
              each counted from zero (only ``packed_moments``, its
              launches a step; no overflow warning; accuracy > 0.8;
              labels equal to the single-device labels of the same
              classifier behind float32 uploads -- the mesh takes the
              raw cloud -- for >= 0.999, the reference's bar; beside
              them phase 4's uint16 labels), the step times (the first
              with the host sizing, then cached) and the peak memory;
              once on the default mesh; ``packed_moments`` against its
              twin at shard 0's band-0 buckets.  Then on one cloud the
              span program (only ``span_moments``), and the rpte model
              whose forest ``fit_device`` grew from a 100k sample of the
              bench features -- ``fit_device_mesh`` on the same rows
              over the four shards, tables bit-equal; its mesh program
              launches only ``packed_moments`` and ``forest_walk``;
              ``vector`` at 100k
              through the segment-wide interp plans; the packed mesh
              program card against a CPU mesh at 100k points of the
              reference pipeline tests' compact scene (each differing
              label a near-tie); ``backend="xla"`` there (no moment
              kernel); ``extract_multichip_2d`` at 100k against a
              (1, 1) mesh (populations equal but where the y-face
              witness holds a row: the reference's halo_y plan, ROADMAP
              Queue C; the rest within 5e-2 where both balls hold 10+
              points) and ``make_train_step_2d`` there for 5 Adam steps
              (the loss falls; step 0's loss and gradient within rtol
              1e-5 of one loss over the mesh's own rows, the (1, 1)
              program's beside them).
16. bench  -- the benchmark (``python -m nimrud_tpu_torch.bench``, the
              port of the reference's ``bench.py``) at full size in its
              own process group, its deadline
              (``NIMRUD_BENCH_DEADLINE_SEC``) what is left of the
              script's 900 s budget less 30 s (it runs last, after
              phases 18 and 17, so that it gets what they leave): the
              headline, designated,
              10M and rpte stages, each in its own process.  Its JSON
              line is printed as ``[bench] {...}``, with each stage's
              numbers on a line of its own; it must exit 0, every stage
              must have run without error, ``value`` > 0, every stage's
              overflow counters 0, and every stage must have launched
              ``packed_moments`` (and no other kernel but the rpte
              stage's ``forest_walk``); its ``packed_moments`` launches
              join the kernels line.
17. variants -- (runs before phase 16) the benchmark's variant stages
              at full size, each
              ``python -m nimrud_tpu_torch.bench.<stage>`` in its own
              process group under ``VARIANT_TIMEOUT``: ``kinds vector``,
              ``kinds oriented``, ``backends``, ``density urban`` and
              ``density veg``.  Each line is printed as ``[variants]
              {...}``, then a summary line; every process must exit 0,
              every overflow counter be 0 and accuracy > 0.8 on the four
              serving stages; ``vector`` may launch only the attribute
              and chebyshev instances, ``oriented`` and both regimes
              only ``packed_moments``; in ``backends`` the XLA variants
              launch no kernel, ``pallas_spans`` only ``span_moments``
              (three an extraction), and its feature sum lies within
              ``SPAN_REL_TOLERANCE`` of ``xla_highest``'s.  Their
              launches join the kernels line.  Then the backends
              stage's three bands are rebuilt in process and
              ``span_moments`` is held against its twin at each band's
              span problem as ``fused_extract_spans`` forms it (q_cap
              128, entry batches of 256); the three bands' feature sum
              from the kernel's slabs must lie within
              ``SPAN_REL_TOLERANCE`` of the stage's ``xla_highest`` sum
              and that of a bf16 control (the same slabs rounded to
              bf16) past it.  Then for each regime the
              bench model is fit in process on
              ``bench.density.make_regime_cloud`` and ``packed_moments``
              held against its twin at the largest-capacity bucket of
              every band of its serving step (``_served_problems``):
              counts equal, moments within ``moment_tolerance``; time,
              bound, share and error as in phase 3.
18. fuzz   -- (runs before phase 17) the reference's random-config
              equivalence test (``tests/test_fuzz_equivalence.py``) on
              the card: draws 0-11 of its generator (``_fuzz_config``,
              a copy; q_cap 16 / 64, m 2 / 3, 1-2 radii, three kinds,
              cube, slab and needle aspects), each scene through six
              routes (``FUZZ_ROUTES``): ``extract_scaleset`` by the
              dense and tiled methods, the fused method on the packed,
              span and XLA backends, and the tiled problem on the entry
              kernel.  Each route counted from zero: the fused packed
              and span routes and the entry route launch only their
              kernel, the other three none.  ``dense`` and the three
              kernel routes against the same route on the CPU (the
              plain twins): populations equal but where the float64
              oracle finds a voxel center within ``_d2_tolerance`` of
              r*r, every other feature within the reference test's
              rtol 2e-3 / atol 5e-3; every route against the card's
              ``dense`` with the reference test's bars (populations
              equal on 0.99 of queries for the tiled routes, 0.98 for
              the fused ones, 0.999 of the values close).  Then each
              kernel's calls, captured on a second run of its route,
              held against its twin at both precisions (``_hold``; the
              entry kernel reads none) at the smallest and the largest
              call of each q_cap and the largest of a draw with m 2 and
              two radii.  Then ``python -m
              nimrud_tpu_torch.examples.serving`` and ``.training`` at
              their default sizes, each in its own process group: exit
              0, accuracy > 0.8.  Its launches join the kernels line.
Phases 10-18 print their wall time.

Each path runs with every launch count set to 0 just before it and read
just after; the kernel comparisons run outside those windows.  The sazo,
attribute and chebyshev instances of ``packed_moments`` have counts of
their own (``packed_moments.sazo_launches``, ``attr_launches``,
``interp_launches``), listed as ``packed_moments_sazo``,
``packed_moments_attr`` and ``packed_moments_interp``; the exclusion
instances of each kernel too (``excl_launches``, ``excl_sazo_launches``,
``excl_attr_launches``), listed with the suffix ``_excl``.

With ``--profile DIR`` a profile phase runs after the serving steps of
phases 4, 4b, 5, 6b and 10, after the tiled runs of phase 6 and after the
vector run of phase 7 (for phase 10 also the forest walk's device time,
the kernels launched inside its ``record_function`` range, as a share
of busy time): ``torch.profiler`` over three steady serving steps of
that backend or layout (clouds staged before the window) or three
``tiled_features`` runs of band 0, printing device
busy time (the union of kernel, memcpy and memset intervals, from
``nimrud_tpu_torch.utils.profiling``), the
traced wall time of each step to synchronize, the device's idle share
and the largest kernels by device time (per step and per call); the
chrome traces and the full kernel tables go to ``DIR``.

Then a JSON line with the kernel records (times, pairs, bound, launches
on the paths; ``library_ms`` is null: no single PyTorch call computes a
masked moment sum or a forest walk) and, last, the result line.
Any failure raises (exit code 1).  Without a CUDA device it exits with
code 2 and prints no result.
"""

import argparse
import collections
import contextlib
import json
import math
import os
import subprocess
import sys
import time

N_POINTS = 1_000_000
N_LARGE = 10_000_000       # the reference's scripts/bench_large.py tile
FIT_SAMPLE = 100_000
E2E_POINTS = 100_000
TIE_GAP = 1e-4
# The two backends serve one classifier through different entry frames
# (the packed path shares one q_cap-512 plan across bands, the span path
# plans each band at q_cap 256): the same neighborhoods are summed in
# other local coordinates, so f32 rounding of the moments and of the
# eigensolver moves features, and sometimes a label by more than a
# near-tie gap.  The flip witness of the span phase holds every such
# label to a float64 oracle; this bounds their share.
MAX_FLIPS = 1e-4
MIN_POP_AGREE = 0.999
WITNESS_SAMPLE = 4096      # points a cloud held against float64 counts
EPS32 = 2.0 ** -24         # f32 unit roundoff
TILED_BATCH = 256
COUNT_COLS = slice(0, None, 16)
# forest_walk: 12 register instances and the wide kernel
INSTANCES = {"packed_moments": 43, "span_moments": 8, "entry_moments": 8,
             "forest_walk": 13}
# the kernels whose every instance sums on the tensor cores (HMMA)
MMA_KERNELS = ("packed_moments", "span_moments", "entry_moments")
# the walk kernel against its plain twin: probabilities of a row whose
# every tree ends at the same leaf differ only in the order of f32 sums
# over at most 64 trees (and f32 division), so by a few ulps of 1.0
WALK_PROBA_TOLERANCE = 1e-6
# the walk phase's drawn forests (checks.drawn_forest): trees, depth,
# levels walked (fewer than depth + 1 leave pairs at no leaf), features,
# classes, decision function, rows (1, and counts off the 128-row block);
# the last five take the wide kernel (64 features or more, more than 64
# trees or more than 16 classes)
WALK_DRAWS = ((10, 14, 14, 12, 3, "wmean", 100_003),
              (1, 1, 1, 4, 2, "wmax", 1),
              (3, 3, 3, 5, 8, "wmean", 127),
              (7, 7, 5, 24, 5, "wmax", 129),
              (10, 10, 10, 13, 2, "wmean", 1000),
              (6, 12, 12, 20, 6, "wmax", 4099),
              (4, 9, 9, 63, 4, "wmean", 2049),
              (64, 6, 6, 16, 16, "wmax", 513),
              (10, 14, 14, 100, 7, "wmean", 20_000),
              (100, 8, 8, 100, 20, "wmean", 1001),
              (3, 6, 4, 64, 5, "wmax", 257),
              (65, 5, 5, 12, 3, "wmean", 130),
              (2, 4, 4, 7, 17, "wmax", 129))
EXCLUDE_RADIUS = 0.1       # the exclusion phase's exclude_radius (m)
KINDS = {"sazo": 3, "oriented": 3, "vector": 3, "geometric": 1,
         "covariance": 1, "eigen": 1}  # clouds each kind serves
# the packed_moments instance family each kind's fit and serving launch
# (launch counts by ``_kernels`` name); every other kernel stays at 0
KIND_KERNELS = {"sazo": ("packed_moments_sazo",),
                "vector": ("packed_moments_attr", "packed_moments_interp")}
MAX_WITNESSED = 0.02       # share of oriented labels a sign or a
                           # rounding-bound vector may move
KNN_K = 16                 # the knn phase: neighbors of knn_features,
KNN_RADIUS = 0.5           # its horizon and the radius search's radius
                           # (the bench's band-0 radius, m),
KNN_K_MAX = 64             # the radius search's k_max,
KNN_SAMPLE = 2000          # queries held against scipy's cKDTree
PARTITION_MAX = 65_536     # the workflows phase: search points a partition
                           # (at 262,144 every bench band fits one),
WORKFLOW_SAMPLES = 50_000  # training rows a class (2 x: FIT_SAMPLE),
SWEEP_POINTS = 200_000     # the sweep's synthetic scan
MESH_SHAPE = (2, 2)        # the multichip phase: one card's four entries,
MC_POINTS = 100_000        # the size of its smaller runs,
MC_TRAIN_STEPS = 5         # Adam steps of its training run (at a rate
MC_TRAIN_LR = 1e-3         # for the raw, unstandardized features),
MC_FEATURE_TOL = 5e-2      # mesh against (1, 1) features (the reference
MC_STURDY = 10             # tests' bound for every row, tests/
                           # test_parallel.py) where both radii hold 10+
                           # points
MIN_MC_AGREE = 0.999       # and the reference's bar for mesh labels
                           # against single-device labels
                           # (tests/test_pipeline.py:223-225)
BENCH_BUDGET = 900         # the bench phase: the script's budget (s),
BENCH_TAIL = 30            # of which the rest of the script keeps this
VARIANT_STAGES = (("kinds", "vector"), ("kinds", "oriented"),
                  ("backends",), ("density", "urban"), ("density", "veg"))
VARIANT_TIMEOUT = 240      # s a variant stage's process may take
FUZZ_DRAWS = 12            # the fuzz phase: the reference's random draws
                           # (tests/test_fuzz_equivalence.py), cases 0-11;
# its six routes, each with the moment kernel it must launch (None: none)
FUZZ_ROUTES = {"dense": None, "tiled": None,
               "fused_packed": "packed_moments", "fused_span": "span_moments",
               "fused_xla": None, "tiled_entry": "entry_moments"}
FUZZ_BACKENDS = {"packed": "packed", "span": "pallas", "xla": "xla"}
# the reference test's bars between routes: the share of queries whose
# population may differ from dense's, and the values where it does not
FUZZ_POP_TOL = {"tiled": 0.01, "tiled_entry": 0.01, "fused_packed": 0.02,
                "fused_span": 0.02, "fused_xla": 0.02}
FUZZ_RTOL = 2e-3
FUZZ_ATOL = 5e-3
FUZZ_CLOSE = 0.999
# backends: pallas_spans' feature sum (the three bands, float64) against
# xla_highest's.  Both sum the same neighbourhoods in other entry
# frames.  On an H100 80GB HBM3 (700 W) the two sums lay 8.26e-9 apart
# in two calls, the stage's line and this check's own sum alike, and a
# bf16 control (the kernel's slabs rounded
# to bf16, ``_backends_holds``) lay 1.42e-4 apart: the tolerance sits
# about 120x above the one and 140x below the other.  The elementwise
# hold of each band's slabs is the strict check; this one ties the
# kernel's features to an independent implementation's.
SPAN_REL_TOLERANCE = 1e-6


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _events_ms(fn, repeat):
    """Device ms a call of ``fn``, over ``repeat`` calls queued behind a
    spin kernel of about 1 ms: a kernel shorter than its wrapper's host
    time is timed back to back, not at the rate the host launches it."""
    import torch
    fn()                                              # warm-up
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(repeat):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeat


def _compare(what, got, ref, tolerance):
    """Counts equal, moments within ``tolerance``, finite.  Returns (max
    abs error, the largest error as a share of its tolerance)."""
    import torch
    _check(torch.equal(got[..., COUNT_COLS], ref[..., COUNT_COLS]),
           f"{what}: counts differ")
    err = (got - ref).abs()
    _check(bool((err <= tolerance).all()), f"{what}: moments outside "
           "tolerance")
    _check(bool(torch.isfinite(got).all()), f"{what}: non-finite slabs")
    share = torch.where(tolerance > 0, err / tolerance, torch.zeros_like(err))
    return float(err.max()), float(share.max())


def _hold(what, kernel, plain, tolerance,
          precisions=("highest", "bf16x2")):
    """One kernel launch against its plain twin on the same inputs, at
    each of ``precisions`` (``kernel`` and ``plain`` take the precision),
    then timed at the first.  Returns a dict of the numbers."""
    import torch
    rec = {"max_abs_err": 0.0}
    for precision in precisions:
        got = kernel(precision)
        torch.cuda.synchronize()
        ref = plain(precision)
        tol = tolerance(ref)
        err, share = _compare(f"{what} {precision}", got, ref, tol)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec[f"{precision}_err_share"] = share
        del got, ref, tol
    rec["ms"] = _events_ms(lambda: kernel(precisions[0]), 20)
    rec["plain_ms"] = _events_ms(lambda: plain(precisions[0]), 3)
    return rec


def _work_text(rec, work):
    """The kernel line's numbers: pairs, bound, share, errors."""
    share = work["bound_ms"] / rec["ms"]
    text = (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; "
            f"{work['pairs']} pairs, bound {work['bound_ms']:.4f} ms "
            f"({work['bound_term']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in work["terms_ms"].items())
            + f"), {100 * share:.1f}% of bound; max_abs_err "
            f"{rec['max_abs_err']:.3g}, largest error as a share of its "
            "tolerance " + ", ".join(
                f"{k[:-10]} {v:.3g}" for k, v in rec.items()
                if k.endswith("_err_share")))
    return text


def _kernels():
    """Each kernel instance's launch count: (wrapper, attribute)."""
    from nimrud_tpu_torch.ops.kernels import forest_walk as fw
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    return {"packed_moments": (pm.packed_moments, "launches"),
            "packed_moments_sazo": (pm.packed_moments, "sazo_launches"),
            "packed_moments_attr": (pm.packed_moments, "attr_launches"),
            "packed_moments_interp": (pm.packed_moments, "interp_launches"),
            "packed_moments_excl": (pm.packed_moments, "excl_launches"),
            "packed_moments_excl_sazo": (pm.packed_moments,
                                         "excl_sazo_launches"),
            "packed_moments_excl_attr": (pm.packed_moments,
                                         "excl_attr_launches"),
            "span_moments": (gk.span_moments, "launches"),
            "span_moments_excl": (gk.span_moments, "excl_launches"),
            "entry_moments": (mk.entry_moments, "launches"),
            "entry_moments_excl": (mk.entry_moments, "excl_launches"),
            "forest_walk": (fw.forest_proba, "launches")}


def _reset_counts():
    for fn, attr in _kernels().values():
        setattr(fn, attr, 0)


def _counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _kernels().items()}


def _only(counts, names, what):
    """Fail unless every kernel but ``names`` stayed at 0 launches."""
    _check(all(v == 0 for k, v in counts.items() if k not in names),
           f"{what} ran another kernel: {counts}")


def _staged_band(model, cloud, device, index=0):
    """Band ``index``'s serving inputs as ``predict_staged`` forms them:
    the dequantized upload, its validity and the band's deduplicated,
    trimmed voxel centers."""
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.features import multiscale

    band = model._fused_band_specs(cloud, cloud)[index]
    q_bucket = multiscale._pow2_bucket(len(cloud))
    quant, dequant = pipeline._quantize_upload(
        cloud, model.bounds[0], model.bounds[1], q_bucket, device)
    query = pipeline._dequantize(quant, dequant)
    valid = torch.arange(q_bucket, device=device) < len(cloud)
    centers, mask, _, _, _ = pipeline._band_search_prep(
        query, valid, band, tile_sorted=model.backend == "packed")
    return band, query, valid, centers, mask


def _packed_problems(model, cloud, device):
    """The packed path's band-0 kernel inputs: ``(side, (q_t, cand_t,
    centers), radii)`` per serving bucket and fit bucket."""
    from nimrud_tpu_torch.ops import device_grid

    problems = []
    # serving: band 0 (the pack grid) at q_cap 512, split capacities
    band, query, valid, centers, mask = _staged_band(model, cloud, device)
    plan = device_grid._pack_plan(query, valid, band.dev_spec)
    spans = device_grid._band_spans(plan, centers, mask, band.dev_spec,
                                    presorted=True)
    buckets, _ = device_grid._bucket_problems(
        plan["q_t"], plan["centers"], spans["span_starts"],
        spans["span_lens"], device_grid._far_extended(spans["sorted_pts"]),
        band.c_cap)
    problems += [("serve", b[:3], band.radii) for b in buckets]
    # fit: band 0 at q_cap 256, one capacity (extract_scaleset_fused)
    prob, cap, radii = _fit_band0(model, cloud, device)
    buckets, _ = device_grid._bucket_problems(
        prob["q_t"], prob["centers"], prob["span_starts"],
        prob["span_lens"], device_grid._far_extended(prob["sorted_pts"]),
        int(cap))
    problems += [("fit", b[:3], radii) for b in buckets]
    return problems


def _fit_specs(model, cloud, n_bands=None):
    """The per-band ``pipeline.BandSpec`` (of the first ``n_bands``) of
    ``extract_scaleset_fused`` on ``cloud`` with the model's bounds: the
    voxel grid, the band's own plan (q_cap 256, entries estimated on the
    cloud), its radii and its packed candidate capacity (``c_cap``)."""
    import numpy as np
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import device_grid, packing, span_host

    lo = np.asarray(model.bounds[0], np.float64)
    hi = np.asarray(model.bounds[1], np.float64)
    q_bucket = multiscale._pow2_bucket(len(cloud))
    specs = []
    for edge, radii in model.scaleset[:n_bands]:
        spec = device_grid.with_entry_estimate(device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, m=model.tile_m,
            q_cap=256, voxel_edge=edge, entry_batch=256, x_seg=32), cloud)
        cap = span_host.candidate_cap(
            cloud, multiscale._host_unique_voxels(cloud, edge,
                                                  bounds=model.bounds), spec)
        specs.append(pipeline.BandSpec(
            packing.GridSpec.fit_bounds(lo, hi, edge), spec, radii,
            c_cap=int(cap)))
    return specs


def _fit_band0(model, cloud, device):
    """Band 0 of ``extract_scaleset_fused`` on ``cloud``: its single-band
    plan and spans (``device_grid._span_problem``), its packed capacity
    and its radii."""
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import device_grid, unique

    band = _fit_specs(model, cloud, 1)[0]
    vox, spec, radii, cap = band.vox_spec, band.dev_spec, band.radii, \
        band.c_cap
    q_bucket = multiscale._pow2_bucket(len(cloud))
    query32 = torch.from_numpy(
        multiscale._pad_rows_f32(cloud, q_bucket)).to(device)
    valid = torch.arange(q_bucket, device=device) < len(cloud)
    vc, _, vm = unique.unique_voxels(query32, vox, valid=valid)
    return (device_grid._span_problem(query32, valid, vc, vm, spec), cap,
            radii)


def _packed_kernel_phase(model, cloud, device):
    """packed_moments vs plain at the shapes the packed path gives it,
    then its sazo instance on the serving buckets.  Returns the serving
    totals of both instances."""
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    sides = {"serve": [], "fit": [], "sazo serve": []}
    for side, (q_t, cand_t, cen), rr in _packed_problems(model, cloud,
                                                         device):
        c_cap = cand_t.shape[1] // q_t.shape[0]
        shape = (f"E={q_t.shape[0]} q_cap={q_t.shape[2]} c_cap={c_cap} "
                 f"radii={len(rr)}")
        for sazo in (False, True) if side == "serve" else (False,):
            name = "sazo " * sazo + side
            work = pm.packed_moments_work(q_t, cand_t, cen, rr,
                                          with_sazo=sazo)
            rec = _hold(
                f"packed_moments {name} {shape}",
                lambda p: pm.packed_moments(q_t, cand_t, cen, rr,
                                            precision=p, with_sazo=sazo),
                lambda p: pm.packed_moments_plain(q_t, cand_t, cen, rr,
                                                  precision=p,
                                                  with_sazo=sazo),
                lambda ref: pm.moment_tolerance(ref, cand_t, cen))
            live = work["pairs"] / (q_t.shape[0] * c_cap * q_t.shape[2])
            print(f"[kernel] packed_moments {name} {shape} (live share of "
                  f"lanes {live:.3f}): {_work_text(rec, work)}", flush=True)
            sides[name].append((rec, work))
    totals = {side: _total(rows) for side, rows in sides.items()}
    for side, (rec, work) in totals.items():
        print(f"[kernel] packed_moments {side} band-0 total: "
              f"{_work_text(rec, work)}", flush=True)
    ratio = totals["sazo serve"][0]["ms"] / totals["serve"][0]["ms"]
    print(f"[kernel] packed_moments sazo instance on the serving band-0 "
          f"inputs: {totals['sazo serve'][0]['ms']:.4f} ms against "
          f"{totals['serve'][0]['ms']:.4f} ms without the fold ("
          f"{ratio:.3f}x); rows 10 / 11 bit-equal to the twin's", flush=True)
    return totals["serve"], totals["sazo serve"]


def _total(rows):
    """Sum the records and works of one call's buckets: times, pairs
    and bounds add; errors take the largest."""
    rec, work = {}, {"terms_ms": {}}
    for r, w in rows:
        for k, v in r.items():
            add = k.endswith("ms")
            rec[k] = rec.get(k, 0.0) + v if add else max(rec.get(k, 0.0), v)
        work["pairs"] = work.get("pairs", 0) + w["pairs"]
        work["bound_ms"] = work.get("bound_ms", 0.0) + w["bound_ms"]
        for k, v in w["terms_ms"].items():
            work["terms_ms"][k] = work["terms_ms"].get(k, 0.0) + v
    work["bound_term"] = max(work["terms_ms"], key=work["terms_ms"].get)
    return rec, work


def _span_problem(model, cloud, device):
    """The span serving path's band-0 kernel inputs: (args, radii,
    span_rows)."""
    from nimrud_tpu_torch.ops import device_grid

    band, query, valid, centers, mask = _staged_band(model, cloud, device)
    prob = device_grid._span_problem(query, valid, centers, mask,
                                     band.dev_spec)
    return device_grid.span_args(prob), band.radii, prob["span_rows"]


def _span_kernel_phase(model, cloud, device):
    """span_moments vs plain at the span serving path's band-0 shapes."""
    return _span_hold("serving band 0", *_span_problem(model, cloud, device))


def _span_hold(what, args, radii, span_rows):
    """span_moments vs plain on one span problem's ``args``
    (``device_grid.span_args``); prints the kernel line.  Returns (the
    numbers of :func:`_hold`, the work)."""
    import torch
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk

    totals = torch.clamp(args[3], 0, span_rows).sum(1)
    shape = (f"E={args[0].shape[0]} q_cap={args[0].shape[1]} "
             f"n_span={args[2].shape[1]} span_rows={span_rows} "
             f"live rows {int(totals.sum())}, "
             f"{int((totals % 16 != 0).sum())} entries of a total not a "
             "multiple of 16")
    work = gk.span_moments_work(*args, radii, span_rows)
    rec = _hold(
        f"span_moments {shape}",
        lambda p: gk.span_moments(*args, radii, span_rows, precision=p),
        lambda p: gk.span_moments_plain(*args, radii, span_rows,
                                        precision=p),
        lambda ref: gk.span_tolerance(ref, *args[1:], span_rows))
    print(f"[kernel] span_moments {what} {shape}: "
          f"{_work_text(rec, work)}", flush=True)
    return rec, work


def entry_batch(problem, cloud, search, device):
    """The ``entry_moments`` inputs (q_local, s_local, s_valid) of the
    first entry batch of a tiled band, as ``tiled_features`` forms
    them."""
    import torch
    from nimrud_tpu_torch.ops import grid

    def put(array, dtype):
        return torch.as_tensor(array).to(device=device, dtype=dtype)

    zero = torch.zeros((1, 3), dtype=torch.float32, device=device)
    batch = slice(0, TILED_BATCH)
    _, q_local, s_local, s_valid, _ = grid._gather_batch(
        torch.cat([put(cloud, torch.float32), zero]),
        torch.cat([put(search, torch.float32), zero]),
        put(problem.candidates, torch.int64),
        (put(problem.query_index[batch], torch.int64),
         put(problem.neighbor_rows[batch], torch.int64),
         put(problem.entry_centers[batch], torch.float32)))
    return q_local.contiguous(), s_local.contiguous(), s_valid.contiguous()


def _entry_kernel_phase(problem, cloud, search, radii, device):
    """entry_moments vs plain on the first entry batch of a tiled
    band."""
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk

    args = entry_batch(problem, cloud, search, device)
    q_local, s_local, s_valid = args
    flat = s_local.shape[1]
    valid = s_valid.sum(1)
    shape = (f"E={q_local.shape[0]} Q={q_local.shape[1]} F={flat}; valid "
             f"share of slots {float(valid.sum()) / s_valid.numel():.4f}, "
             f"k16 groups run per entry "
             f"{float(((valid + 15) // 16).float().mean()):.2f} of "
             f"{-(-flat // 16)}")
    work = mk.entry_moments_work(*args, radii)
    rec = _hold(
        f"entry_moments {shape}",
        lambda _: mk.entry_moments(*args, radii),
        lambda _: mk.entry_moments_plain(*args, radii),
        lambda ref: mk.entry_tolerance(ref, args[1], args[2]),
        precisions=("highest",))
    print(f"[kernel] entry_moments tiled band 0, first batch {shape}: "
          f"{_work_text(rec, work)}", flush=True)
    return rec, work


def _serve(model, clouds, with_proba=False, attrs=None):
    """stage + predict_staged + synchronize per cloud (with its
    attribute columns, ``attrs``, for ``vector``): per-step times
    (total, stage, predict+sync) ms, labels, probabilities, counters."""
    import torch
    steps, labels, probs, diags = [], [], [], []
    for c, a in zip(clouds, attrs or [None] * len(clouds)):
        t0 = time.perf_counter()
        staged = model.stage(c, attributes=a)
        t1 = time.perf_counter()
        out = model.predict_staged(staged, with_proba=with_proba,
                                   with_diag=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.append((1e3 * (t2 - t0), 1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        labels.append(out[0].cpu())
        probs.append(out[1].cpu() if with_proba else None)
        diags.append({k: int(v) for k, v in out[-1].items()})
    return steps, labels, probs, diags


def _steps_text(steps):
    return "; ".join(f"{t:.3f}, {s:.3f}, {p:.3f}" for t, s, p in steps)


def _check_served(what, diags, labels, truths):
    from nimrud_tpu_torch.pipeline import COUNTERS
    accs = [float((lab.numpy() == t).mean()) for lab, t in zip(labels,
                                                                truths)]
    for d in diags:
        _check(all(d[k] == 0 for k in COUNTERS),
               f"{what} overflow counters {d}")
    _check(all(a > 0.8 for a in accs), f"{what} accuracy {accs}")
    return accs


def _top2_gap(probs):
    import torch
    top2 = torch.sort(probs, dim=1).values[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _d2_tolerance(radius, extent):
    """Bound on |f32 d2 - float64 d2| for a pair near ``radius`` whose
    entry-local coordinates lie within ``extent``: each axis difference
    carries at most eps = u (2 extent + 2 r) (two rounded subtractions of
    the entry center, one between them), the rounded squares and sums
    3u d2, and f32(r*r) u r^2 (5u r^2 covers both)."""
    eps = EPS32 * (2.0 * extent + 2.0 * radius)
    return (2.0 * math.sqrt(3.0) * eps * radius + 3.0 * eps * eps
            + 5.0 * EPS32 * radius * radius)


def _float64_oracle(points, centers, radius, tol, exclude=None,
                    exclude_tol=0.0):
    """Per point against ``centers``, in float64: the population within
    ``radius`` (and, with ``exclude``, not closer than it), the number of
    centers with |d2 - r^2| <= ``tol`` or |d2 - exclude^2| <=
    ``exclude_tol`` (which f32 may put on either side), the smallest of
    those gaps, the minimal feature block (k, 4) and the covariance
    (k, 6)."""
    import torch
    from nimrud_tpu_torch.features import layouts
    r2 = float(radius) ** 2
    e2 = None if exclude is None else float(exclude) ** 2
    x, y, z = centers.to(torch.float64).unbind(1)
    aug = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                       y * y, y * z, z * z], 1)
    near, gap, sums = [], [], []
    for chunk in torch.split(points.to(torch.float64), 32):
        d2 = ((chunk[:, None, 0] - x).square()
              + (chunk[:, None, 1] - y).square()
              + (chunk[:, None, 2] - z).square())
        off = (d2 - r2).abs()
        close, inside = off <= tol, d2 <= r2
        if e2 is not None:
            off_e = (d2 - e2).abs()
            close |= off_e <= exclude_tol
            inside &= d2 >= e2
            off = torch.minimum(off, off_e)
        near.append(close.sum(1))
        gap.append(off.min(1).values)
        sums.append(inside.to(torch.float64) @ aug)
    sums = torch.cat(sums)
    count = sums[:, 0]
    mean = sums[:, 1:4] / count.clamp(min=1.0)[:, None]
    mx, my, mz = mean.unbind(1)
    cov = sums[:, 4:10] / count.clamp(min=1.0)[:, None] - torch.stack(
        [mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz], 1)
    block = layouts.minimal_block(count, mean, cov,
                                  points.to(torch.float64))
    return (count.to(torch.int64), torch.cat(near), torch.cat(gap), block,
            cov)


def _feature_bounds(count, cov, points, entry_centers, radius):
    """Bounds on |f32 - float64| of [centroid displacement, eig1, eig2]
    where the f32 neighbor set is the float64 one, for a backend that
    summed the moments about ``entry_centers``.  With n neighbors and
    local coordinates within l = |q - c|_inf + r: mean_local carries
    (n + 1) u l, each covariance entry d = (3n + 7) u l^2 (raw sums less
    the mean's square), so each eigenvalue 3d (Weyl) and the trace
    t 3d + 2ut; the f32 trigonometric eigensolver adds 4 p sqrt(1024 u)
    / 3 + 16 u t (a half-determinant off by 512 u moves acos by at most
    sqrt(1024 u)), p the deviator's scale."""
    import torch
    n = count.to(torch.float64)
    q = points.to(torch.float64)
    ell = (q - entry_centers.to(torch.float64)).abs().amax(1) + radius
    glob = q.abs().amax(1) + ell
    centroid = (math.sqrt(3.0) * ((n + 1) * EPS32 * ell
                                  + EPS32 * (glob + radius))
                + 3 * EPS32 * radius)
    delta = (3 * n + 7) * EPS32 * ell ** 2
    t = cov[:, 0] + cov[:, 3] + cov[:, 5]
    dev = cov[:, [0, 3, 5]] - (t / 3)[:, None]
    p = torch.sqrt(((dev ** 2).sum(1) + 2 * (cov[:, [1, 2, 4]] ** 2).sum(1))
                   / 6)
    trig = 4 * p * math.sqrt(1024 * EPS32) / 3 + 16 * EPS32 * t
    dt = 3 * delta + 2 * EPS32 * t
    eig = torch.where(t > dt, (3 * delta + trig + dt)
                      / (t - dt).clamp(min=1e-30) + EPS32, math.inf)
    return torch.stack([centroid, eig, eig], 1)


def _max_cap(cap):
    """The largest capacity of an int or split ``(caps, bounds)`` one."""
    return max(cap[0]) if isinstance(cap, tuple) else int(cap)


def _attr_bound(staged):
    """Bound on |card - CPU| of each ``vector`` feature column of a staged
    cloud: both take the same neighbor sets (exact f32 tests) and sum
    the same attributes in other orders, first in the interp (at most
    c_i terms a sum), then in the extraction (c_e terms, of the interp's
    means); two f32 sums of n terms of |value| <= e differ by at most
    2 (n - 1) u n e, and each division by the count adds u |mean|, so a
    mean moves by at most 2 (c_i + c_e + 2) u e, e the column's extent
    over the cloud."""
    import torch
    attrs = staged["attributes"][:staged["n_query"]].cpu().to(torch.float64)
    extent = attrs.abs().amax(0)
    c_i = max(_max_cap(band.cap) for band in staged["specs"])
    c_e = max(_max_cap(band.c_cap) for band in staged["specs"])
    return 2.0 * (c_i + c_e + 2) * EPS32 * extent


def _vector_bounds(count, cov, points, entry_centers, radius):
    """Bounds on |f32 - float64| of the (x, y) components of the smallest
    and the middle eigenvectors (``oriented``): a covariance entry off by
    d (``_feature_bounds``) moves the matrix by at most 3d and each
    eigenvalue by 3d plus the solver's error; twice the Davis-Kahan
    bound over the eigenvalue gap, 2 (6d + solver) / gap, bounds each
    component.  Returns (k, 4) in the layout's column order."""
    import torch
    n = count.to(torch.float64)
    q = points.to(torch.float64)
    ell = (q - entry_centers.to(torch.float64)).abs().amax(1) + radius
    delta = (3 * n + 7) * EPS32 * ell ** 2
    lam = torch.linalg.eigvalsh(_full_cov(cov))           # ascending
    t = lam.sum(1).abs()
    p = (lam - t[:, None] / 3).square().sum(1).div(6).sqrt()
    solver = 4 * p * math.sqrt(1024 * EPS32) / 3 + 16 * EPS32 * t
    err = 2 * (6 * delta + solver)
    small = err / (lam[:, 1] - lam[:, 0]).clamp(min=1e-300)
    middle = err / torch.minimum(lam[:, 1] - lam[:, 0],
                                 lam[:, 2] - lam[:, 1]).clamp(min=1e-300)
    return torch.stack([small, small, middle, middle], 1)


def _rounding_witness(kind, model, staged, rows, feats, ref):
    """Whether only f32 rounding moved the features of ``rows`` between
    two evaluations of ``model``'s serving step on ``staged`` (a CPU
    staging of the cloud): ``feats`` (the card's rows; for ``oriented``
    reconciled with ``ref``'s by ``layouts.reconcile``) and ``ref`` (the
    CPU's), both (n, width) on the CPU.  ``staged`` may also carry
    ``exclude_radius`` (the oracle leaves those pairs out, and a pair at
    its rounding bound counts as near) and ``band_plans`` (each band
    planned on its own spec, as ``extract_scaleset_fused`` plans it, not
    on the shared plan of the packed step: the entry frames follow).
    Every feature must lie within its stated f32 bound:

    * ``vector``: each column of the two within ``_attr_bound``;
    * the geometry layouts, per band against a float64 oracle over the
      band's voxel centers (``_float64_oracle``): the population (the
      count of ``minimal``, the density of the others) of each equal,
      within an ulp, to that of the float64 population, with no
      candidate within the rounding bound of r^2; the centroid and the
      eigenvalue columns within ``_feature_bounds`` of the oracle's (in
      the plan's entry frames), the eigenvector columns of ``oriented``
      within ``_vector_bounds`` of each other, the ``sazo`` values
      equal.  A row with a candidate at the rounding bound may hold
      another population than float64: there the two must agree on it
      and lie within twice the bounds of each other.

    Returns (held (k,) bool, the largest difference as a share of its
    bound over every checked feature)."""
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.features import layouts
    from nimrud_tpu_torch.ops import unique

    rows = rows.cpu()
    mine, theirs = feats[rows].to(torch.float64), ref[rows].to(torch.float64)
    if kind == "vector":
        bound = _attr_bound(staged).repeat(mine.shape[1]
                                           // staged["attributes"].shape[1])
        ratio = (mine - theirs).abs() / bound
        return (ratio <= 1).all(1), float(ratio.max()) if len(rows) else 0.0
    query = staged["query"]
    if staged["dequant"] is not None:
        query = pipeline._dequantize(query, staged["dequant"])
    query = query.cpu()
    valid = torch.arange(query.shape[0]) < staged["n_query"]
    points = query[rows]
    specs = staged["specs"]
    extent = max(math.hypot(*(d * band.dev_spec.tile_edge
                              for d in band.dev_spec.dims))
                 for band in specs) + max(edge for edge, _ in model.scaleset)
    pack_spec = min((band.dev_spec for band in specs),
                    key=lambda spec: spec.tile_edge)
    frames = _entry_centers(query, valid, pack_spec)[rows]
    exclude = staged.get("exclude_radius")
    exclude_tol = 0.0 if exclude is None else _d2_tolerance(exclude, extent)
    width = layouts.LAYOUT_WIDTHS[kind]
    held = torch.ones(len(rows), dtype=torch.bool)
    worst, col = 0.0, 0
    for band in specs:
        if staged.get("band_plans"):
            frames = _entry_centers(query, valid, band.dev_spec)[rows]
        centers, _, mask = unique.unique_voxels(query, band.vox_spec,
                                                valid=valid)
        for radius in band.radii:
            exact, near, _, block, cov = _float64_oracle(
                points, centers[mask], radius, _d2_tolerance(radius, extent),
                exclude, exclude_tol)
            bounds = _feature_bounds(exact, cov, points, frames, radius)
            if kind == "oriented":
                eigs = torch.linalg.eigvalsh(_full_cov(cov))      # ascending
                trace = eigs.sum(1)
                norm = torch.where(
                    ((exact >= 2) & (trace > 0))[:, None],
                    eigs[:, :2] / trace.clamp(min=1e-300)[:, None], 0.0)
                oracle = torch.cat([block[:, 1:2], norm], 1)
            else:
                oracle = block[:, 1:4]
            # the population column: the count itself for ``minimal``,
            # its density for the other layouts
            dens = exact.to(torch.float64) if kind == "minimal" \
                else layouts.sphere_density(exact.to(torch.float32),
                                            radius).to(torch.float64)
            scalar = slice(col + 1, col + 4)
            apart = near > 0
            ratios = []
            for f in (mine, theirs):
                same = (f[:, col] - dens).abs() <= 2.0 ** -22 * dens
                held &= same | apart
                ratios.append((f[:, scalar] - oracle).abs() / bounds)
            both = (mine[:, col] == theirs[:, col]) \
                & ((mine[:, scalar] - theirs[:, scalar]).abs()
                   / (2 * bounds) <= 1).all(1)
            ratio = torch.where(apart[:, None], 0.0,
                                torch.maximum(*ratios))
            held &= torch.where(apart, both, (ratio <= 1).all(1))
            if kind == "oriented":
                vec = slice(col + 4, col + 8)
                vr = (mine[:, vec] - theirs[:, vec]).abs() / (2 * _vector_bounds(
                    exact, cov, points, frames, radius))
                held &= (vr <= 1).all(1)
                ratio = torch.cat([ratio, vr], 1)
            if layouts.needs_sazo(kind):
                held &= mine[:, col + 4] == theirs[:, col + 4]
            if ratio.numel():
                worst = max(worst, float(ratio.max()))
            col += width
    return held, worst


def _full_cov(cov):
    """(k, 6) upper triangles -> (k, 3, 3) symmetric matrices."""
    import torch
    full = torch.zeros(cov.shape[0], 3, 3, dtype=cov.dtype)
    for k, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                (2, 2))):
        full[:, i, j] = full[:, j, i] = cov[:, k]
    return full


def _entry_centers(query, valid, spec):
    """Each query's entry center in ``spec``'s plan, in caller order."""
    from nimrud_tpu_torch.ops import device_grid
    plan = device_grid._pack_plan(query, valid, spec)
    pos = device_grid._unsort_positions(plan, spec, query.shape[0], 0)
    return plan["centers"][pos // spec.q_cap]


def _flip_witness(packed, span, clouds, span_labels, packed_labels):
    """Why the labels of the per-band model ``span`` (the span backend,
    or the XLA one) and the packed model differ.  On each cloud, both
    backends'
    serving features, at every point where the labels or populations
    differ and at WITNESS_SAMPLE sampled points, against a float64
    oracle over the same voxel centers: each population must equal the
    float64 count up to the candidates within the f32 rounding bound of
    r^2, and where no candidate is that close, the other features must
    lie within the f32 rounding bounds of the oracle's
    (``_feature_bounds``) in each backend's own entry frames (the XLA
    plan's one coarse tile an entry, ``_xla_entry_centers``).  Returns
    the report line."""
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.ops import unique
    from nimrud_tpu_torch.utils import checks

    generator = torch.Generator().manual_seed(0)
    totals = collections.Counter()
    worst_gap, worst_ratio, tols = 0.0, [0.0, 0.0], {}
    for cloud, lab, ref in zip(clouds, span_labels, packed_labels):
        st_s, st_p = span.stage(cloud), packed.stage(cloud)
        _check(torch.equal(st_s["query"], st_p["query"]),
               "the two backends staged different coordinates")
        feats = [checks.served_features(m, st)
                 for m, st in ((span, st_s), (packed, st_p))]
        differ = (feats[0][:, 0::4] != feats[1][:, 0::4]).any(1).cpu()
        flipped = lab != ref
        totals["flips"] += int(flipped.sum())
        totals["flips at differing populations"] += int(
            (flipped & differ).sum())
        totals["differing points"] += int(differ.sum())
        rows = torch.unique(torch.cat([
            (flipped | differ).nonzero()[:, 0],
            torch.randperm(len(cloud), generator=generator)[
                :WITNESS_SAMPLE]])).to(st_s["query"].device)
        flip_rows = flipped.to(rows.device)[rows]
        boundary = torch.zeros_like(flip_rows)
        totals["checked points"] += len(rows)
        query = pipeline._dequantize(st_s["query"], st_s["dequant"])
        valid = torch.arange(query.shape[0], device=query.device) \
            < len(cloud)
        points = query[rows]
        # entry centers, queries and voxel centers all lie in the grid
        # boxes (voxel centers up to half an edge outside)
        extent = max(math.hypot(*(d * band.dev_spec.tile_edge
                                  for d in band.dev_spec.dims))
                     for band in st_s["specs"] + st_p["specs"]) \
            + max(edge for edge, _ in span.scaleset)
        pack_spec = min((band.dev_spec for band in st_p["specs"]),
                        key=lambda spec: spec.tile_edge)
        packed_frames = _entry_centers(query, valid, pack_spec)[rows]
        frame_of = _xla_entry_centers if span.backend == "xla" \
            else _entry_centers
        col = 0
        for band in st_s["specs"]:
            centers, _, mask = unique.unique_voxels(query, band.vox_spec,
                                                    valid=valid)
            frames = (frame_of(query, valid, band.dev_spec)[rows],
                      packed_frames)
            for radius in band.radii:
                tols[radius] = _d2_tolerance(radius, extent)
                exact, near, gap, block, cov = _float64_oracle(
                    points, centers[mask], radius, tols[radius])
                block = block[:, 1:]
                got = [f[rows, col:col + 4] for f in feats]
                for k, (f, frame) in enumerate(zip(got, frames)):
                    pop = f[:, 0].to(torch.int64)
                    _check(bool(((pop - exact).abs() <= near).all()),
                           f"a served population at r {radius} is off its "
                           "float64 count by more than the candidates at "
                           "the rounding bound")
                    ratio = ((f[:, 1:].to(torch.float64) - block).abs()
                             / _feature_bounds(exact, cov, points, frame,
                                               radius))[near == 0]
                    _check(bool((ratio <= 1).all()),
                           f"a served feature at r {radius} is off the "
                           "float64 oracle by more than f32 rounding")
                    if ratio.numel():
                        worst_ratio[k] = max(worst_ratio[k],
                                             float(ratio.max()))
                boundary |= near > 0
                apart = got[0][:, 0] != got[1][:, 0]
                totals["differing populations"] += int(apart.sum())
                if bool(apart.any()):
                    worst_gap = max(worst_gap, float(gap[apart].max()))
                col += 4
        totals["flips with a boundary candidate"] += int(
            (flip_rows & boundary).sum())
    return (f"{dict(totals)}; every differing population has a "
            f"candidate within {worst_gap:.3g} of r^2 (bounds "
            + ", ".join(f"r {r}: {t:.3g}" for r, t in tols.items())
            + "); features off the float64 oracle by at most "
            f"{worst_ratio[0]:.3g} ({span.backend}) and "
            f"{worst_ratio[1]:.3g} (packed) of their f32 rounding bounds")


def _span_phase(model, packed_labels, clouds, truths, fit_cloud, device,
                profile_dir=None):
    """The span serving path, counted from zero (then profiled, with a
    ``profile_dir``), its labels against the packed ``model``'s with the
    flip witness; then its kernel held against the plain twin.  Returns
    (launches, kernel record numbers)."""
    import torch
    from nimrud_tpu_torch.utils import workload

    span = workload.make_bench_model(fit_cloud, backend="pallas",
                                     device=device)
    span.install_classifier(model.classifier, fit_cloud)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    steps, labels, probs, diags = _serve(span, clouds, with_proba=True)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    accs = _check_served("span", diags, labels, truths)
    flips, gaps = 0, []
    for lab, prob, ref in zip(labels, probs, packed_labels):
        differ = lab != ref
        flips += int(differ.sum())
        gaps += _top2_gap(prob)[differ].tolist()
    n = sum(len(c) for c in clouds)
    n_tied = sum(g < TIE_GAP for g in gaps)
    print(f"[span] serve steps ms (total, stage, predict+sync): "
          f"{_steps_text(steps)}; launches {counts}; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; peak {peak_gb:.3f} GiB; {flips} of {n} "
          f"labels differ from the packed model's ({n_tied} of them at "
          f"top-two gaps < {TIE_GAP}, the largest gap "
          f"{max(gaps, default=0.0):.3g})", flush=True)
    _check(counts["span_moments"] > 0, "span_moments did not run in "
           "span serving")
    _only(counts, ("span_moments",), "span serving")
    _check(flips <= MAX_FLIPS * n, "too many labels differ between the "
           "packed and span backends")
    t0 = time.perf_counter()
    witness = _flip_witness(model, span, clouds, labels, packed_labels)
    print(f"[span] flip witness ({time.perf_counter() - t0:.1f} s): "
          f"{witness}", flush=True)
    if profile_dir:
        _serving_profile(span, profile_dir)
    return counts["span_moments"], _span_kernel_phase(span, clouds[0],
                                                      device)


def _tiled_phase(model, cloud, device, profile_dir=None):
    """The tiled entry path per band, counted from zero, against the
    packed extraction's populations (then band 0 profiled, with a
    ``profile_dir``); then its kernel held against the plain twin on
    band 0.  Returns (launches, kernel record, band 0's (problem,
    search, radii))."""
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import grid

    packed = model.extract_device(cloud)
    torch.cuda.synchronize()
    _reset_counts()
    band0, rows = None, []
    for b, (edge, radii) in enumerate(model.scaleset):
        t0 = time.perf_counter()
        search = multiscale._host_unique_voxels(cloud, edge,
                                                bounds=model.bounds)
        problem = grid.build_tiled_problem(
            cloud, search, max(radii), query_tile_factor=3,
            entry_batch=TILED_BATCH)
        t1 = time.perf_counter()
        feats = grid.tiled_features(problem, cloud, search, radii,
                                    "minimal", entry_batch=TILED_BATCH,
                                    backend="pallas", device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _check(bool(torch.isfinite(feats).all()),
               f"tiled band {b}: non-finite features")
        agree = float((feats[:, 0] == packed[:, 4 * b]).float().mean())
        rows.append(f"band {b} (edge {edge}, r {radii}): host plan "
                    f"{t1 - t0:.3f} s, device {1e3 * (t2 - t1):.3f} ms, "
                    f"{problem.n_entries} entries, stats {problem.stats}, "
                    f"population equal to packed for {agree:.6f}")
        _check(agree >= MIN_POP_AGREE,
               f"tiled band {b}: populations agree for {agree}")
        if b == 0:
            band0 = (problem, search, radii)
    counts = _counts()
    for row in rows:
        print(f"[tiled] {row}")
    print(f"[tiled] launches {counts}", flush=True)
    _check(counts["entry_moments"] > 0, "entry_moments did not run in the "
           "tiled path")
    _only(counts, ("entry_moments",), "the tiled path")
    problem, search, radii = band0
    if profile_dir:
        _profile_phase("[profile tiled band 0]", "tiled_band0", [
            lambda: grid.tiled_features(problem, cloud, search, radii,
                                        "minimal", entry_batch=TILED_BATCH,
                                        backend="pallas", device=device)]
            * 3, profile_dir)
    return counts["entry_moments"], _entry_kernel_phase(
        problem, cloud, search, radii, device), band0


def _xla_entry_centers(query, valid, spec):
    """Each query's entry center in the XLA candidate-table plan of
    ``spec`` (``device_grid.build_tables``: one coarse tile an entry),
    in caller order; queries without an entry slot get zeros."""
    import torch
    from nimrud_tpu_torch.ops import device_grid
    query_index, _, _, centers = device_grid.build_tables(
        query, valid, query[:1], valid[:1], spec)
    flat = query_index.reshape(-1)
    entry = torch.arange(query_index.shape[0], device=query.device
                         ).repeat_interleave(query_index.shape[1])
    live = flat >= 0
    frames = torch.zeros_like(query)
    frames[flat[live]] = centers[entry[live]]
    return frames


def _interp_s_cap(cloud, edges):
    """``vector_s_cap`` for the gather and matmul interps on ``cloud``:
    the densest cell of their grids at each band's edge (the voxel grid
    anchored half an edge below the cloud, the tile grid 1e-3 below),
    with a quarter's headroom for f32 binning, as a power of two."""
    import numpy as np
    from nimrud_tpu_torch.ops import grid
    lo = cloud.min(0).astype(np.float64)
    worst = 0
    for edge in edges:
        for origin in (lo - edge / 2, lo - 1e-3):
            cell = np.floor((cloud - origin) / edge).astype(np.int64)
            worst = max(worst, int(np.unique(cell, axis=0,
                                             return_counts=True)[1].max()))
    return grid._pow2(worst + worst // 4)


def _xla_bands(model, cloud, attr_width=None):
    """The XLA bands' sizes of ``model``'s serving step on ``cloud``:
    entries, q_cap, entry batches and candidate lanes a query
    ((m + 2)^3 fine tiles of s_cap rows), and the matmul interp's
    entries where a band has its spec."""
    def size(d):
        return (f"e_cap {d.e_cap}, q_cap {d.q_cap}, "
                f"{-(-d.e_cap // d.entry_batch)} batches of "
                f"{d.entry_batch}, S {(d.m + 2) ** 3 * d.s_cap}")
    return "; ".join(
        f"band {b}: {size(band.dev_spec)}"
        + ("" if band.interp_spec is None
           else f" (interp grid: {size(band.interp_spec)})")
        for b, band in enumerate(model._fused_band_specs(
            cloud, cloud, attr_width=attr_width)))


def _xla_phase(model, packed_labels, clouds, truths, fit_cloud, fit_labels,
               band0, device, profile_dir=None):
    """``backend="xla"``: the bench model fit and served on the XLA
    candidate-table path at full width, counted from zero (no moment
    kernel may launch); its labels with the packed model's classifier
    against the packed labels (the flip witness); card against CPU at
    100k; the other XLA paths once each (sazo on ``"pallas"``, vector
    with 9 and 7 attribute columns, the tiled and dense methods, an
    edge-0 model); and band 0's tiled problem on the XLA path beside
    the entry kernel.  With ``profile_dir``, three xla steps profiled."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import grid
    from nimrud_tpu_torch.utils import checks, workload

    t_phase = time.perf_counter()
    xla = workload.make_bench_model(fit_cloud, backend="xla", device=device)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    xla.fit(fit_cloud, fit_labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    _only(_counts(), (), "the xla fit")
    steps, labels, _, diags = _serve(xla, clouds)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    accs = _check_served("xla", diags, labels, truths)
    _only(counts, (), "the xla serving step")
    print(f"[xla] fit {fit_s:.3f} s; serve steps ms (total, stage, "
          f"predict+sync): {_steps_text(steps)}; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; moment kernel launches {sum(counts.values())}"
          f"; peak {peak_gb:.3f} GiB; {_xla_bands(xla, fit_cloud)}",
          flush=True)
    if profile_dir:
        _serving_profile(xla, profile_dir)

    # the packed model's classifier on the XLA path: its labels against
    # the packed step's, every difference held by the flip witness
    same = workload.make_bench_model(fit_cloud, backend="xla", device=device)
    same.install_classifier(model.classifier, fit_cloud)
    _, same_labels, same_probs, _ = _serve(same, clouds, with_proba=True)
    flips = [lab != ref for lab, ref in zip(same_labels, packed_labels)]
    n = sum(len(c) for c in clouds)
    n_flips = sum(int(f.sum()) for f in flips)
    n_tied = sum(int((f & (_top2_gap(p) < TIE_GAP)).sum())
                 for f, p in zip(flips, same_probs))
    _check(n_flips <= MAX_FLIPS * n, f"{n_flips} of {n} labels differ "
           "between the packed and xla backends")
    t0 = time.perf_counter()
    witness = _flip_witness(model, same, clouds, same_labels, packed_labels)
    print(f"[xla] with the packed classifier: {n_flips} of {n} labels "
          f"differ from the packed step's ({n_tied} at top-two gaps < "
          f"{TIE_GAP}); flip witness ({time.perf_counter() - t0:.1f} s): "
          f"{witness}", flush=True)
    del same

    # card against CPU at 100k, the same classifier
    small, _ = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, _ = workload.make_bench_cloud(E2E_POINTS, seed=1)
    card = workload.make_bench_model(small, backend="xla", device=device)
    card.install_classifier(xla.classifier, small)
    cpu = workload.make_bench_model(small, backend="xla", device="cpu")
    cpu.install_classifier(checks.on_cpu(xla.classifier), small)
    g_lab, g_prob = card.predict_staged(card.stage(other), with_proba=True)
    t0 = time.perf_counter()
    c_lab, c_prob = cpu.predict_staged(cpu.stage(other), with_proba=True)
    cpu_s = time.perf_counter() - t0
    gaps = torch.minimum(_top2_gap(g_prob.cpu()), _top2_gap(c_prob))
    differ = g_lab.cpu() != c_lab
    print(f"[xla] card vs cpu: {E2E_POINTS} points, {int(differ.sum())} "
          f"labels differ, {int((differ & (gaps < TIE_GAP)).sum())} of them "
          f"at near-ties; cpu serve {cpu_s:.2f} s", flush=True)
    _check(not bool((differ & (gaps >= TIE_GAP)).any()),
           "xla: card and cpu labels differ away from near-ties")
    _check(int(differ.sum()) <= MAX_FLIPS * E2E_POINTS,
           "xla: too many card / cpu label flips")
    del card, cpu, xla

    # the other XLA paths, once each, counted from zero: sazo at 100k;
    # vector on its 50 m quadrant (the matmul interp's tables cover the
    # site whatever its points), vector_s_cap sized on its densest cell
    small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)[1]
    quad = (small[:, 0] < 50) & (small[:, 1] < 50)
    runs = []
    for kind, backend, width in (("sazo", "pallas", 0),
                                 ("vector", "packed", 9),
                                 ("vector", "packed", 7)):
        c, lab, attrs, kw = small, small_labels, None, {}
        if width:
            c, lab = small[quad], small_labels[quad]
            attrs = np.concatenate([
                workload.make_bench_attributes(lab),
                np.random.default_rng(width).random(
                    (len(c), width - 2)).astype(np.float32)], axis=1)
            kw = {"vector_s_cap": _interp_s_cap(c, workload.BENCH_EDGES)}
        m = workload.make_bench_model(c, kind=kind, backend=backend,
                                      device=device, **kw)
        m.fit(c, lab, sample=len(c) // 2, attributes=attrs)
        _reset_counts()
        steps, labels, _, diags = _serve(m, [c], attrs=[attrs])
        counts = _counts()
        accs = _check_served(f"xla {kind} {backend} A={width}", diags,
                             labels, [lab])
        _only(counts, (), f"the {kind} serving step on XLA bands")
        runs.append(f"{kind} on {backend} (A={width}, {len(c)} points, "
                    f"vector_s_cap {m.vector_s_cap}): "
                    f"step {_steps_text(steps)} ms, accuracy {accs[0]:.4f}"
                    f"; {_xla_bands(m, c, width or None)}")
    from nimrud_tpu_torch.pipeline import GeometryClassifier
    edge0 = GeometryClassifier([(0.0, (0.5,))], kind="minimal",
                               classifier_kwargs={"epochs": 10, "seed": 0},
                               bounds=(small.min(0), small.max(0)),
                               device=device)
    edge0.fit(small, small_labels, sample=E2E_POINTS // 2)
    _reset_counts()
    t0 = time.perf_counter()
    e_labels, e_diag = edge0.predict_device(small, with_diag=True)
    torch.cuda.synchronize()
    e_ms = 1e3 * (time.perf_counter() - t0)
    _only(_counts(), (), "the edge-0 predict")
    _check(all(int(v) == 0 for v in e_diag.values()),
           f"edge-0 predict counters {e_diag}")
    e_acc = float((e_labels.cpu().numpy() == small_labels).mean())
    # its populations (the tiled method's XLA sums) against the entry
    # kernel's on the same tiled problem
    tp = grid.build_tiled_problem(small, small, 0.5, query_tile_factor=3,
                                  entry_batch=TILED_BATCH)
    pops = grid.tiled_features(tp, small, small, (0.5,), "minimal",
                               entry_batch=TILED_BATCH, backend="pallas",
                               device=device)[:, 0]
    e_agree = float((edge0.extract_device(small)[:, 0] == pops).float()
                    .mean())
    _check(e_agree >= MIN_POP_AGREE,
           f"edge-0 populations agree with the entry kernel's for {e_agree}")
    bqs = TILED_BATCH * tp.stats["q_cap"] * tp.stats["n_off"] \
        * tp.stats["s_cap"]
    runs.append(f"edge-0 model (r 0.5, the raw cloud searched by the "
                f"tiled method: {tp.n_entries} entries, stats {tp.stats}, "
                f"(B, Q, S) {4 * bqs / 2**30:.3f} GiB a f32 tensor): "
                f"predict {e_ms:.3f} ms, accuracy {e_acc:.4f}, populations "
                f"equal to the entry kernel's for {e_agree:.6f}")
    for method, cloud_m in (("tiled", clouds[0]),
                            ("dense", clouds[0][:16_000])):
        _reset_counts()
        t0 = time.perf_counter()
        feats = multiscale.extract_scaleset_device(
            cloud_m, cloud_m, model.scaleset, "minimal", method=method,
            device=device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        _only(_counts(), (), f"extract_scaleset_device(method={method!r})")
        _check(bool(torch.isfinite(feats).all())
               and feats.shape == (len(cloud_m), 12),
               f"method={method!r}: features")
        runs.append(f"extract_scaleset_device(method={method!r}) on "
                    f"{len(cloud_m)} points: {ms:.3f} ms")
    for run in runs:
        print(f"[xla] {run}", flush=True)

    # band 0's tiled problem: the XLA sums beside the entry kernel
    problem, search, radii = band0
    cloud0 = clouds[0]
    timed = {}
    for backend in ("xla", "pallas"):
        timed[backend] = _events_ms(lambda: grid.tiled_features(
            problem, cloud0, search, radii, "minimal",
            entry_batch=TILED_BATCH, backend=backend, device=device), 2)
    got = {b: grid.tiled_features(problem, cloud0, search, radii, "minimal",
                                  entry_batch=TILED_BATCH, backend=b,
                                  device=device) for b in timed}
    agree = float((got["xla"][:, 0] == got["pallas"][:, 0]).float().mean())
    _check(agree >= MIN_POP_AGREE, f"tiled band 0: xla and pallas "
           f"populations agree for {agree}")
    print(f"[xla] tiled band 0 ({problem.n_entries} entries, "
          f"{problem.stats}): xla {timed['xla']:.3f} ms, pallas "
          f"{timed['pallas']:.3f} ms a run (CUDA events), populations "
          f"equal for {agree:.6f}; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _kinds_phase(fit_cloud, fit_labels, clouds, truths, device,
                 profile_dir=None):
    """The other layouts on the packed path, each fitted and served with
    every launch count set to 0 just before it (``vector`` with the
    bench attributes of its fit cloud; then profiled, with a
    ``profile_dir``).  Returns the launches of each
    instance family in its kind's run (``KIND_KERNELS``), the fit
    launches and serving steps of each, and the fitted vector model."""
    import torch
    from nimrud_tpu_torch.utils import workload

    launches, per_kind, vector = {}, {}, None
    for kind, n_clouds in KINDS.items():
        attrs = serve_attrs = None
        served, served_truths = clouds[:n_clouds], truths[:n_clouds]
        if kind == "vector":
            # the interp's capacities are sized on the raw fit cloud (raw
            # points an entry), and the bench's other seeds place their
            # walls elsewhere and overflow them (interp_dropped), in the
            # reference as here: vector serves its fit cloud, as the
            # reference's scripts/bench_kinds.py does
            attrs = workload.make_bench_attributes(fit_labels)
            served = [fit_cloud] * n_clouds
            served_truths = [fit_labels] * n_clouds
            serve_attrs = [attrs] * n_clouds
        model = workload.make_bench_model(fit_cloud, kind=kind,
                                          device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        model.fit(fit_cloud, fit_labels, sample=FIT_SAMPLE, attributes=attrs)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts = _counts()
        steps, labels, _, diags = _serve(model, served, attrs=serve_attrs)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        accs = _check_served(kind, diags, labels, served_truths)
        mine = KIND_KERNELS.get(kind, ("packed_moments",))
        serve = {k: counts[k] - fit_counts[k] for k in mine}
        print(f"[kinds] {kind}: fit {fit_s:.3f} s ("
              + ", ".join(f"{fit_counts[k]} {k}" for k in mine)
              + " launches); serve steps ms (total, stage, predict+sync): "
              f"{_steps_text(steps)}; serve launches "
              + ", ".join(f"{k} {v} ({v / n_clouds:g} a step)"
                          for k, v in serve.items())
              + "; accuracy " + ", ".join(f"{a:.4f}" for a in accs)
              + f"; counters {diags}; launches {counts}; peak "
              f"{peak_gb:.3f} GiB", flush=True)
        _check(all(fit_counts[k] > 0 and serve[k] > 0 for k in mine),
               f"{kind}: {mine} did not run in fit and in serving")
        _only(counts, mine, f"{kind}: the packed path")
        for k in KIND_KERNELS.get(kind, ()):
            launches[k] = counts[k]
            per_kind[k] = (fit_counts[k], serve[k] / n_clouds)
        if kind == "vector":
            vector = model
            if profile_dir:
                _serving_profile(model, profile_dir, fit_cloud, attrs)
    return launches, per_kind, vector


def _vector_problems(model, cloud, attrs, device):
    """The vector path's band-0 kernel inputs as serving forms them:
    the packed interp's (chebyshev, one radius, the voxel edge: centers
    against the raw cloud and its attributes, at its capacity buckets)
    and the extraction's (the shared plan against the band's centers and
    their interpolated attributes, at its buckets).  Returns ``(side,
    (q_t, cand_t, centers), radii)`` per bucket."""
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import device_grid, interp, unique

    band = model._fused_band_specs(cloud, cloud,
                                    attr_width=attrs.shape[1])[0]
    vox, dev, radii, ispec, icap, c_cap = band
    q_bucket = multiscale._pow2_bucket(len(cloud))
    quant, dequant = pipeline._quantize_upload(
        cloud, model.bounds[0], model.bounds[1], q_bucket, device)
    query = pipeline._dequantize(quant, dequant)
    valid = torch.arange(q_bucket, device=device) < len(cloud)
    attrs_dev = torch.from_numpy(multiscale._pad_rows_f32(
        attrs, q_bucket)).to(device)
    problems = []
    centers, _, mask = unique.unique_voxels(query, vox, valid=valid)
    prob = device_grid._span_problem(centers, mask, query, valid, ispec,
                                     attrs=attrs_dev)
    buckets, _ = device_grid._bucket_problems(
        prob["q_t"], prob["centers"], prob["span_starts"],
        prob["span_lens"], device_grid._far_extended(prob["sorted_pts"]),
        icap)
    problems += [("interp", b[:3], (float(vox.edge_length),))
                 for b in buckets]
    centers, mask, center_attrs = interp.packed_interp(
        query, valid, attrs_dev, vox, ispec, icap)
    plan = device_grid._pack_plan(query, valid, dev)
    spans = device_grid._band_spans(plan, centers, mask, dev,
                                    attrs=center_attrs)
    buckets, _ = device_grid._bucket_problems(
        plan["q_t"], plan["centers"], spans["span_starts"],
        spans["span_lens"], device_grid._far_extended(spans["sorted_pts"]),
        c_cap)
    problems += [("attr", b[:3], radii) for b in buckets]
    return problems


def _ptxas_lines(name, kernel="packed_moments"):
    """The ptxas lines of one kernel instance (``cuda_build.kernel_name``)
    in the build of ``kernel``."""
    from nimrud_tpu_torch.ops.kernels import cuda_build
    _, report = cuda_build.build(kernel)
    return [ln for ln in cuda_build.ptxas_usage(report)
            if ln.startswith(name + ":")]


def _vector_kernel_phase(model, cloud, attrs, device, per_kind):
    """The attribute and chebyshev instances against the plain twin at
    the vector path's band-0 shapes (``_vector_problems``), at both
    precisions: counts equal, moment and attribute rows within
    ``moment_tolerance``; each instance's time, bound, share, launches a
    step and ptxas lines.  Returns the records of both families."""
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    n_attr = attrs.shape[1]
    slots = pm.attr_slots(n_attr)
    sides = {"interp": [], "attr": []}
    for side, (q_t, cand_t, cen), rr in _vector_problems(model, cloud,
                                                         attrs, device):
        metric = "chebyshev" if side == "interp" else "euclidean"
        c_cap = cand_t.shape[1] // q_t.shape[0]
        shape = (f"E={q_t.shape[0]} q_cap={q_t.shape[2]} c_cap={c_cap} "
                 f"radii={len(rr)} A={n_attr}")
        work = pm.packed_moments_work(q_t, cand_t, cen, rr, n_attr=n_attr,
                                      metric=metric)
        rec = _hold(
            f"packed_moments {side} {shape}",
            lambda p: pm.packed_moments(q_t, cand_t, cen, rr, precision=p,
                                        n_attr=n_attr, metric=metric),
            lambda p: pm.packed_moments_plain(q_t, cand_t, cen, rr,
                                              precision=p, n_attr=n_attr,
                                              metric=metric),
            lambda ref: pm.moment_tolerance(ref, cand_t, cen, n_attr=n_attr))
        live = work["pairs"] / (q_t.shape[0] * c_cap * q_t.shape[2])
        print(f"[kernel] packed_moments {side} {shape} (live share of "
              f"lanes {live:.3f}): {_work_text(rec, work)}", flush=True)
        sides[side].append((rec, work))
    out = {}
    for side, family, instance in (
            ("interp", "packed_moments_interp",
             f"packed_interp_kernel<{slots}>"),
            ("attr", "packed_moments_attr",
             f"packed_attr_kernel<1, {slots}>")):
        rec, work = _total(sides[side])
        fit, step = per_kind[family]
        print(f"[kernel] {family} ({instance}) vector band-0 total: "
              f"{_work_text(rec, work)}; launches: fit {fit}, serving "
              f"{step:g} a step; ptxas: "
              + " | ".join(_ptxas_lines(instance)), flush=True)
        out[family] = (rec, work)
    return out


def _e2e_phase(device):
    """Both backends on the card against the same classifier on the CPU:
    labels agree except at near-ties; then the sazo, oriented and vector
    layouts on the packed backend."""
    from nimrud_tpu_torch.utils import checks, workload

    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, other_labels = workload.make_bench_cloud(E2E_POINTS, seed=1)
    gpu = workload.make_bench_model(small, device=device)
    gpu.fit(small, small_labels, sample=E2E_POINTS // 2)
    clf, cpu_clf = gpu.classifier, checks.on_cpu(gpu.classifier)
    for backend in ("packed", "pallas"):
        card = workload.make_bench_model(small, backend=backend,
                                         device=device)
        card.install_classifier(clf, small)
        cpu = workload.make_bench_model(small, backend=backend,
                                        device="cpu")
        cpu.install_classifier(cpu_clf, small)
        g_lab, g_prob = card.predict_staged(card.stage(other),
                                            with_proba=True)
        t0 = time.perf_counter()
        c_lab = cpu.predict_staged(cpu.stage(other))
        cpu_s = time.perf_counter() - t0
        near_tie = _top2_gap(g_prob.cpu()) < TIE_GAP
        differ = g_lab.cpu() != c_lab
        print(f"[e2e] {backend}: {E2E_POINTS} points, {int(differ.sum())} "
              f"labels differ (card vs cpu), {int(near_tie.sum())} "
              f"near-ties; cpu serve {cpu_s:.2f} s", flush=True)
        _check(not bool((differ & ~near_tie).any()),
               f"{backend}: card and cpu labels differ away from near-ties")
        _check(int(differ.sum()) <= MAX_FLIPS * E2E_POINTS,
               f"{backend}: too many label flips")
    for kind in ("sazo", "oriented", "vector"):
        _e2e_kind(kind, small, small_labels, other, other_labels, device)


def _e2e_kind(kind, small, small_labels, other, other_labels, device,
              classifier="linear"):
    """One layout on the packed backend, card against CPU with the card
    fit's classifier (``vector`` on its fit cloud with the bench
    attributes; ``classifier="rpte"`` the forest).  Each differing label
    has a near-tie (top-two gap < TIE_GAP
    on either side), or for ``oriented`` the sign witness
    (``layouts.reconcile``: the card's rows with the eigenvector signs
    turned to the CPU's and the vectors of nearly equal eigenvalues taken
    from it give the CPU's labels), or the rounding witness
    (``_rounding_witness``: every feature of the two rows within its
    stated f32 bound, so only rounding moved the label).  Either witness
    first needs the card's label to be the classifier's label of the
    card's own rows (for the forest: or the walk witness,
    ``checks.walk_witness``, holds the row).  At most MAX_FLIPS of the
    labels at near-ties or by rounding, and MAX_WITNESSED by signs."""
    import torch
    from nimrud_tpu_torch.features import layouts
    from nimrud_tpu_torch.utils import checks, workload

    attrs = other_attrs = None
    if kind == "vector":
        # served on its fit cloud, as in the kinds phase: the interp's
        # capacities are sized on the fit cloud's raw density
        attrs = other_attrs = workload.make_bench_attributes(small_labels)
        other = small
    gpu = workload.make_bench_model(small, kind=kind, classifier=classifier,
                                    device=device)
    gpu.fit(small, small_labels, sample=E2E_POINTS // 2, attributes=attrs)
    cpu_clf = checks.on_cpu(gpu.classifier)
    cpu = workload.make_bench_model(small, kind=kind, device="cpu")
    cpu.install_classifier(cpu_clf, small, attributes=attrs)
    st_g = gpu.stage(other, attributes=other_attrs)
    st_c = cpu.stage(other, attributes=other_attrs)
    g_lab, g_prob = gpu.predict_staged(st_g, with_proba=True)
    t0 = time.perf_counter()
    c_lab, c_prob = cpu.predict_staged(st_c, with_proba=True)
    cpu_s = time.perf_counter() - t0
    gaps = torch.minimum(_top2_gap(g_prob.cpu()), _top2_gap(c_prob))
    differ = g_lab.cpu() != c_lab
    left = differ & (gaps >= TIE_GAP)
    found = collections.Counter({"near-ties": int((differ & ~left).sum())})
    if bool(left.any()):
        g_feats = checks.served_features(gpu, st_g).cpu()
        c_feats = checks.served_features(cpu, st_c)
        # a witness first needs the card's label to be its own rows' label
        own = cpu_clf.proba_device(g_feats).argmax(1) == g_lab.cpu()
        if classifier == "rpte" and not bool(own.all()):
            walked = (~own).nonzero()[:, 0]
            own[walked] = checks.walk_witness(cpu_clf._tables, g_feats,
                                              cpu_clf.max_depth_, walked)
            found["walk witness"] = int(own[walked].sum())
        found["labels not of the card's rows"] = int((left & ~own).sum())
        if kind == "oriented":
            rec, flipped, taken = layouts.reconcile(kind, g_feats, c_feats)
            signs = left & own & (cpu_clf.proba_device(rec).argmax(1)
                                  == c_lab)
            found["sign witness"] = int(signs.sum())
            found["rows with a sign turned"] = int(flipped.sum())
            found["rows with a near-degenerate vector"] = int(taken.sum())
            left &= ~signs
            g_feats = rec
        rows = (left & own).nonzero()[:, 0]
        held, ratio = _rounding_witness(kind, cpu, st_c, rows, g_feats,
                                        c_feats)
        rounding = torch.zeros_like(left)
        rounding[rows[held]] = True
        found["rounding witness"] = int(rounding.sum())
        found["largest feature difference as a share of its bound"] = \
            float(f"{ratio:.4g}")
        left &= ~rounding
    print(f"[e2e] {kind} packed ({classifier}): {E2E_POINTS} points, "
          f"{int(differ.sum())} labels differ (card vs cpu): {dict(found)}; "
          f"cpu serve {cpu_s:.2f} s", flush=True)
    _check(not bool(left.any()),
           f"{kind}: card and cpu labels differ without a witness at rows "
           f"{left.nonzero()[:8, 0].tolist()}")
    _check(found["near-ties"] + found["rounding witness"]
           <= MAX_FLIPS * E2E_POINTS, f"{kind}: too many label flips")
    _check(found["sign witness"] <= MAX_WITNESSED * E2E_POINTS,
           f"{kind}: too many labels moved by eigenvector signs")


def _exclusion_kernels(model, cloud, band0, device):
    """The exclusion instances against their twins at the exclusion
    paths' band-0 shapes, at both precisions (``entry_moments`` at its
    one): ``packed_moments`` on the fit band-0 inputs of
    ``extract_scaleset_fused`` (one capacity), its sazo instance on them
    and its attribute instance on them with two attribute rows; the
    span kernel on the same band's spans (``backend="pallas"`` plans the
    band alike); the entry kernel on the tiled band 0's first batch
    (``band0``).  Then each at ``exclude_radius`` 0.0 against the same
    instance family without exclusion, bit for bit, and timed beside it
    on the same inputs; and the share of band 0's pairs the exclusion
    removed.  Returns ({name: (record, work)}, the removed share)."""
    import torch
    from nimrud_tpu_torch.ops import device_grid
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    e = EXCLUDE_RADIUS
    prob, cap, radii = _fit_band0(model, cloud, device)
    (q_t, cand_t, cen, _), = device_grid._bucket_problems(
        prob["q_t"], prob["centers"], prob["span_starts"],
        prob["span_lens"], device_grid._far_extended(prob["sorted_pts"]),
        cap)[0]
    gen = torch.Generator(device=device).manual_seed(3)
    attrs = torch.rand((2, cand_t.shape[1]), generator=gen, device=device)
    attrs[:, cand_t[0] == pm.FAR] = pm.FAR
    cand_a = torch.cat([cand_t, attrs]).contiguous()
    shape = (f"E={q_t.shape[0]} q_cap={q_t.shape[2]} "
             f"c_cap={cand_t.shape[1] // q_t.shape[0]} radii={len(radii)}")
    out = {}
    packed = (("packed_moments_excl", cand_t, {}, "packed_excl_kernel<1, "
               "false>"),
              ("packed_moments_excl_sazo", cand_t, {"with_sazo": True},
               "packed_excl_kernel<1, true>"),
              ("packed_moments_excl_attr", cand_a, {"n_attr": 2},
               "packed_attr_excl_kernel<1, 4>"))
    for name, cand, kw, instance in packed:
        work = pm.packed_moments_work(q_t, cand, cen, radii,
                                      exclude_radius=e, **kw)
        rec = _hold(
            f"{name} {shape}",
            lambda p: pm.packed_moments(q_t, cand, cen, radii,
                                        exclude_radius=e, precision=p, **kw),
            lambda p: pm.packed_moments_plain(q_t, cand, cen, radii,
                                              exclude_radius=e, precision=p,
                                              **kw),
            lambda ref: pm.moment_tolerance(ref, cand, cen,
                                            n_attr=kw.get("n_attr", 0)))
        zero = pm.packed_moments(q_t, cand, cen, radii, exclude_radius=0.0,
                                 **kw)
        _check(torch.equal(zero, pm.packed_moments(q_t, cand, cen, radii,
                                                   **kw)),
               f"{name}: exclusion at 0.0 is not bit-equal to none")
        base = _events_ms(lambda: pm.packed_moments(q_t, cand, cen, radii,
                                                    **kw), 20)
        print(f"[exclude] {name} ({instance}) fit band 0 {shape}"
              f"{' A=2' if 'n_attr' in kw else ''}: {_work_text(rec, work)}"
              f"; {rec['ms'] / base:.3f}x the family without exclusion on "
              f"these inputs ({base:.4f} ms); at exclude_radius 0.0 "
              "bit-equal to no exclusion; ptxas: "
              + " | ".join(_ptxas_lines(instance)), flush=True)
        out[name] = (rec, work)
    with_e = pm.packed_moments(q_t, cand_t, cen, radii, exclude_radius=e)
    without = pm.packed_moments(q_t, cand_t, cen, radii)
    removed = float(without[..., COUNT_COLS].sum()
                    - with_e[..., COUNT_COLS].sum())
    share = removed / out["packed_moments_excl"][1]["pairs"]

    args = device_grid.span_args(prob)
    rows = prob["span_rows"]
    work = gk.span_moments_work(*args, radii, rows, exclude_radius=e)
    rec = _hold(
        f"span_moments_excl E={args[0].shape[0]}",
        lambda p: gk.span_moments(*args, radii, rows, exclude_radius=e,
                                  precision=p),
        lambda p: gk.span_moments_plain(*args, radii, rows, exclude_radius=e,
                                        precision=p),
        lambda ref: gk.span_tolerance(ref, *args[1:], rows))
    _check(torch.equal(gk.span_moments(*args, radii, rows,
                                       exclude_radius=0.0),
                       gk.span_moments(*args, radii, rows)),
           "span_moments_excl: exclusion at 0.0 is not bit-equal to none")
    base = _events_ms(lambda: gk.span_moments(*args, radii, rows), 20)
    print(f"[exclude] span_moments_excl (span_excl_kernel<1>) band 0 "
          f"E={args[0].shape[0]} q_cap={args[0].shape[1]} "
          f"n_span={args[2].shape[1]} span_rows={rows}: "
          f"{_work_text(rec, work)}; {rec['ms'] / base:.3f}x the kernel "
          f"without exclusion on these inputs ({base:.4f} ms); at "
          "exclude_radius 0.0 bit-equal to no exclusion; ptxas: "
          + " | ".join(_ptxas_lines("span_excl_kernel<1>", "span_moments")),
          flush=True)
    out["span_moments_excl"] = (rec, work)

    problem, search, t_radii = band0
    args = entry_batch(problem, cloud, search, device)
    work = mk.entry_moments_work(*args, t_radii, exclude_radius=e)
    rec = _hold(
        f"entry_moments_excl E={args[0].shape[0]}",
        lambda _: mk.entry_moments(*args, t_radii, exclude_radius=e),
        lambda _: mk.entry_moments_plain(*args, t_radii, exclude_radius=e),
        lambda ref: mk.entry_tolerance(ref, args[1], args[2]),
        precisions=("highest",))
    _check(torch.equal(mk.entry_moments(*args, t_radii, exclude_radius=0.0),
                       mk.entry_moments(*args, t_radii)),
           "entry_moments_excl: exclusion at 0.0 is not bit-equal to none")
    base = _events_ms(lambda: mk.entry_moments(*args, t_radii), 20)
    print(f"[exclude] entry_moments_excl (entry_excl_kernel<1>) tiled band 0, "
          f"first batch E={args[0].shape[0]} Q={args[0].shape[1]} "
          f"F={args[1].shape[1]}: {_work_text(rec, work)}; "
          f"{rec['ms'] / base:.3f}x the kernel without exclusion on these "
          f"inputs ({base:.4f} ms); at exclude_radius 0.0 bit-equal to no "
          "exclusion; ptxas: "
          + " | ".join(_ptxas_lines("entry_excl_kernel<1>", "entry_moments")),
          flush=True)
    out["entry_moments_excl"] = (rec, work)
    print(f"[exclude] band 0 of the fit extraction: the exclusion at "
          f"{e} m removed {removed:.0f} of "
          f"{out['packed_moments_excl'][1]['pairs']} pairs ({share:.6f})",
          flush=True)
    _check(share > 0, "the exclusion removed no pair at band 0")
    return out, share


def _counted(fn):
    """``fn()`` run to synchronize with every launch count set to 0 just
    before: (its result, ms, the counts)."""
    import torch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0), _counts()


def _exclusion_phase(cloud, labels, clouds, truths, band0, device):
    """The ``exclude_radius`` slice: its kernels against their twins
    (``_exclusion_kernels``); the exclusion model at full width, counted
    from zero (``make_bench_model(cloud, exclude_radius=0.1)``, fit, then
    ``predict_device`` with its counters and ``predict`` on the three
    clouds; ``stage`` must raise); the other paths that reach an
    exclusion instance, each counted from zero: the span extraction
    (``extract_scaleset_fused(backend="pallas")``), the tiled band 0,
    the ``sazo`` and ``vector`` extractions; then card against CPU
    (``_e2e_exclusion``).  Returns (launches, kernel records)."""
    import warnings

    import numpy as np
    import torch
    from nimrud_tpu_torch.features import layouts, multiscale
    from nimrud_tpu_torch.ops import grid
    from nimrud_tpu_torch.utils import workload

    e = EXCLUDE_RADIUS
    model = workload.make_bench_model(cloud, exclude_radius=e, device=device)
    records, _ = _exclusion_kernels(model, cloud, band0, device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model.fit(cloud, labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = _counts()
    steps, served, diags = [], [], []
    for c in clouds:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error")     # an overflow would warn
            lab = model.predict(c)
        steps.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        dev_lab, diag = model.predict_device(c, with_diag=True)
        torch.cuda.synchronize()
        steps[-1] = (steps[-1], 1e3 * (time.perf_counter() - t0))
        _check(np.array_equal(dev_lab.cpu().numpy(), lab),
               "predict and predict_device labels differ")
        served.append(torch.from_numpy(lab))
        diags.append({k: int(v) for k, v in diag.items()})
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    accs = _check_served("exclusion", diags, served, truths)
    try:
        model.stage(cloud)
        staged = True
    except ValueError:
        staged = False
    _check(not staged, "stage did not raise for an exclusion model")
    serve = counts["packed_moments_excl"] - fit_counts["packed_moments_excl"]
    print(f"[exclude] path: make_bench_model(exclude_radius={e}), fit "
          f"{fit_s:.3f} s ({fit_counts['packed_moments_excl']} "
          f"packed_moments_excl launches); steps ms (predict, "
          f"predict_device + synchronize): "
          + "; ".join(f"{a:.3f}, {b:.3f}" for a, b in steps)
          + f"; {serve} serving launches ({serve / (2 * len(clouds)):g} a "
          "call); accuracy " + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; launches {counts}; peak {peak_gb:.3f} GiB; "
          "stage raises", flush=True)
    _check(fit_counts["packed_moments_excl"] > 0 and serve > 0,
           "packed_moments_excl did not run in fit and in serving")
    _only(counts, ("packed_moments_excl",), "the exclusion path")
    launches = {"packed_moments_excl": counts["packed_moments_excl"]}

    packed = model.extract_device(cloud)
    runs = (
        ("span_moments_excl", "the span extraction (backend='pallas')",
         lambda: multiscale.extract_scaleset_fused(
             cloud, cloud, model.scaleset, "minimal", exclude_radius=e,
             bounds=model.bounds, backend="pallas", device=device),
         ("span_moments_excl",), 4),
        ("entry_moments_excl", "the tiled path, band 0",
         lambda: grid.tiled_features(
             band0[0], cloud, band0[1], band0[2], "minimal",
             exclude_radius=e, entry_batch=TILED_BATCH, backend="pallas",
             device=device),
         ("entry_moments_excl",), 4),
        ("packed_moments_excl_sazo", "the sazo extraction",
         lambda: multiscale.extract_scaleset_fused(
             cloud, cloud, model.scaleset, "sazo", exclude_radius=e,
             bounds=model.bounds, device=device),
         ("packed_moments_excl_sazo",), 5),
        ("packed_moments_excl_attr", "the vector extraction (A=2)",
         lambda: multiscale.extract_scaleset_fused(
             cloud, cloud, model.scaleset, "vector",
             attributes=workload.make_bench_attributes(labels),
             exclude_radius=e, bounds=model.bounds, device=device),
         ("packed_moments_excl_attr", "packed_moments_interp"), None))
    radii = [r for _, rr in model.scaleset for r in rr]
    for name, what, fn, mine, width in runs:
        feats, ms, counts = _counted(fn)
        _check(bool(torch.isfinite(feats).all()), f"{what}: non-finite")
        text = ""
        if width:
            # population columns: counts (minimal), densities (sazo)
            pop = feats[:, 0::width]
            ref = packed[:, 0:pop.shape[1] * 4:4]
            if width == 5:
                ref = torch.stack([layouts.sphere_density(ref[:, i], r)
                                   for i, r in enumerate(radii[:ref.shape[1]])],
                                  1)
            agree = float((pop == ref).float().mean())
            text = f"; populations equal to the packed path's for {agree:.6f}"
            _check(agree >= MIN_POP_AGREE, f"{what}: populations agree "
                   f"for {agree}")
        print(f"[exclude] {what}: {ms:.3f} ms to synchronize{text}; "
              f"launches {counts}", flush=True)
        _check(all(counts[k] > 0 for k in mine), f"{what}: {mine} did not "
               "run")
        _only(counts, mine, what)
        launches[name] = counts[name]
    del model, packed
    _e2e_exclusion(device)
    return launches, records


def _e2e_exclusion(device):
    """The exclusion model at E2E_POINTS on the card and on the CPU (the
    twins), the card fit's classifier on both: ``extract`` (the path
    has no staged handle) gives equal populations on both, every
    feature of WITNESS_SAMPLE sampled rows and of every differing label
    within its stated f32 bound of a float64 oracle that leaves the
    excluded pairs out (``_rounding_witness``), and each differing label
    a near-tie or witnessed so, at most MAX_FLIPS of them."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.utils import checks, workload

    e = EXCLUDE_RADIUS
    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, _ = workload.make_bench_cloud(E2E_POINTS, seed=1)
    gpu = workload.make_bench_model(small, exclude_radius=e, device=device)
    gpu.fit(small, small_labels, sample=E2E_POINTS // 2)
    cpu_clf = checks.on_cpu(gpu.classifier)
    cpu = workload.make_bench_model(small, exclude_radius=e, device="cpu")
    cpu.install_classifier(cpu_clf, small)
    g_feats = gpu.extract_device(other).cpu()
    g_lab = gpu.predict_device(other).cpu()
    t0 = time.perf_counter()
    c_feats = cpu.extract_device(other)
    cpu_s = time.perf_counter() - t0
    c_prob = cpu_clf.proba_device(c_feats)
    c_lab = c_prob.argmax(1).to(torch.int32)
    g_prob = cpu_clf.proba_device(g_feats)
    # the populations (minimal's count columns)
    _check(torch.equal(g_feats[:, 0::4], c_feats[:, 0::4]),
           "e2e exclusion: card and cpu populations differ")
    own = g_prob.argmax(1).to(torch.int32) == g_lab
    _check(bool(own.all()), "e2e exclusion: card labels are not its rows'")
    gaps = torch.minimum(_top2_gap(g_prob), _top2_gap(c_prob))
    differ = g_lab != c_lab
    near_tie = differ & (gaps < TIE_GAP)
    sample = torch.from_numpy(np.random.default_rng(7).choice(
        len(other), WITNESS_SAMPLE, replace=False))
    rows = torch.unique(torch.cat([sample, differ.nonzero()[:, 0]]))
    q_bucket = multiscale._pow2_bucket(len(other))
    staged = {"query": torch.from_numpy(multiscale._pad_rows_f32(
                  other, q_bucket)),
              "dequant": None, "n_query": len(other),
              "specs": tuple(_fit_specs(cpu, other)),
              "exclude_radius": e, "band_plans": True}
    t0 = time.perf_counter()
    held, ratio = _rounding_witness("minimal", cpu, staged, rows, g_feats,
                                    c_feats)
    witness_s = time.perf_counter() - t0
    witnessed = torch.zeros_like(differ)
    witnessed[rows[held]] = True
    print(f"[e2e] exclusion packed: {E2E_POINTS} points, populations equal "
          f"card vs cpu; {int(differ.sum())} labels differ "
          f"({int(near_tie.sum())} at near-ties, "
          f"{int((differ & ~near_tie & witnessed).sum())} by the rounding "
          f"witness); {int(held.sum())} of {len(rows)} witnessed rows "
          f"within their f32 bounds, the largest feature difference "
          f"{ratio:.4g} of its bound ({witness_s:.1f} s); cpu extract "
          f"{cpu_s:.2f} s", flush=True)
    _check(bool(held.all()), "e2e exclusion: features outside their f32 "
           f"bounds at rows {rows[~held][:8].tolist()}")
    _check(not bool((differ & ~near_tie & ~witnessed).any()),
           "e2e exclusion: card and cpu labels differ without a witness")
    _check(int(differ.sum()) <= MAX_FLIPS * E2E_POINTS,
           "e2e exclusion: too many label flips")


def _serving_profile(model, out_dir, cloud=None, attrs=None):
    """Three steady serving steps of ``model``'s backend (clouds staged
    before the window: seeds 3-5, or ``cloud`` with its ``attrs`` three
    times), profiled."""
    from nimrud_tpu_torch.utils import workload
    clouds = [cloud] * 3 if cloud is not None else [
        workload.make_bench_cloud(N_POINTS, seed=s)[0] for s in (3, 4, 5)]
    staged = [model.stage(c, attributes=attrs) for c in clouds]
    name = model.backend if model.kind == "minimal" else model.kind
    _profile_phase(f"[profile {name}]", f"serving_{name}",
                   [lambda st=st: model.predict_staged(st) for st in staged],
                   out_dir)


def _profile_phase(tag, stem, steps, out_dir, annotation=None):
    """Device busy time, idle share and kernel times of ``steps`` (calls,
    each run to synchronize; the first also once before the window), from
    a ``torch.profiler`` trace.  The chrome trace and the full kernel
    table go to ``out_dir``.  ``annotation``: the name of a
    ``record_function`` range; the device time of the kernels launched
    inside it is printed as a share of busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nimrud_tpu_torch.utils import profiling

    os.makedirs(out_dir, exist_ok=True)
    steps[0]()                                         # warm-up
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step in steps:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
    trace = os.path.join(out_dir, f"{stem}_trace.json")
    prof.export_chrome_trace(trace)
    # raises where the profiler traced no device work
    events = profiling.trace_events(trace)
    device = profiling.device_events(events)
    busy_us, _ = profiling.device_track_stats(events)
    table = profiling.device_op_table(events, top=None)
    n_steps = len(steps)
    with open(os.path.join(out_dir, f"{stem}_kernels.txt"), "w") as f:
        for ms, n, name in table:
            f.write(f"{ms / n_steps:.4f} ms/step\t{n / n_steps:g} "
                    f"calls/step\t{name}\n")
    wall = sum(walls)
    if annotation is not None:
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name") == annotation]
        inside = {e["args"]["correlation"] for e in events
                  if e.get("ph") == "X"
                  and e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})
                  and any(lo <= float(e["ts"]) <= hi for lo, hi in ranges)}
        mine = sum(float(e["dur"]) for e in device
                   if e.get("args", {}).get("correlation") in inside)
        _check(len(ranges) >= n_steps and mine > 0,
               f"{annotation}: {len(ranges)} ranges, no device time")
        print(f"{tag} {annotation}: {mine / 1e3 / n_steps:.3f} ms/step of "
              f"device time, {100 * mine / busy_us:.1f}% of busy",
              flush=True)
    print(f"{tag} {n_steps} steps: traced ms to synchronize "
          + ", ".join(f"{w:.3f}" for w in walls)
          + f"; device busy {busy_us / 1e3 / n_steps:.3f} ms/step; idle "
          f"share {1 - busy_us / 1e3 / wall:.4f}; "
          f"{len(device) / n_steps:g} device events/step", flush=True)
    for ms, n, name in table[:8]:
        print(f"{tag} {ms / n_steps:.4f} ms/step "
              f"({100 * ms / (busy_us / 1e3):.1f}% of busy), "
              f"{n / n_steps:g} calls/step, {ms / n:.4f} ms/call: "
              f"{name[:90]}", flush=True)


def _host_ms(fn, repeat=3):
    """Least host ms of ``repeat`` calls of ``fn``, and its last result."""
    best, out = None, None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        ms = 1e3 * (time.perf_counter() - t0)
        best = ms if best is None else min(best, ms)
    return best, out


def _same_bits(a, b):
    """Equal dtype, shape and bits, element-wise through tuples and the
    tiled plan's tables."""
    import numpy as np
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    if hasattr(a, "query_index"):
        return all(_same_bits(getattr(a, f), getattr(b, f))
                   for f in ("query_index", "neighbor_rows", "candidates",
                             "entry_centers")) and a.stats == b.stats
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _native_phase(model, cloud, clouds, device):
    """The C++ host runtime: its build, each of its eight functions
    against its NumPy twin on the bench cloud, bit for bit, with both
    host times (least of three calls); then ``stage`` of the packed model
    with ``impl="numpy"`` and native on the three clouds."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import grid, native

    t0 = time.perf_counter()
    native.library()
    runtimes = sorted({line.split()[-1] for line in open("/proc/self/maps")
                       if "libgomp" in line or "libiomp" in line})
    print(f"[native] g++ build and load {time.perf_counter() - t0:.2f} s: "
          f"{os.path.basename(native.library_path())}; OpenMP runtimes "
          f"{runtimes}", flush=True)
    lo, hi = model.bounds
    spec = model._fused_band_specs(cloud, cloud)[0].dev_spec
    q_bucket = multiscale._pow2_bucket(len(cloud))
    step = max(float((hi.astype(np.float64) - lo).max()), 1e-6) / 65000.0
    rng = np.random.default_rng(5)
    ties = ((rng.integers(0, 64999, (len(cloud), 3)) + 0.5) / 64
            ).astype(np.float32)
    search = multiscale._host_unique_voxels(cloud, model.scaleset[0][0],
                                            bounds=model.bounds)
    text = "\n".join(f"{x:.5f},{y:.5f},{z:.5f}"
                     for x, y, z in cloud.tolist()).encode()
    cases = [
        ("quantize_u16", lambda impl: native.quantize_u16(
            cloud, lo, step, pad_to=q_bucket, impl=impl)),
        ("quantize_u16 ties", lambda impl: native.quantize_u16(
            ties, np.zeros(3), 1 / 64, pad_to=q_bucket, impl=impl)),
        ("minmax3", lambda impl: native.minmax3(cloud, impl=impl))]
    cases += [(f"tile_sort m={m}", lambda impl, m=m: native.tile_sort(
        cloud, spec.lo, spec.tile_edge, spec.dims, m, impl=impl))
        for m in (1, 3)]
    cases.append((
        "build_tiled_problem band 0 (fill_table, mark_neighbors, "
        "neighbor_rows)", lambda impl: grid.build_tiled_problem(
            cloud, search, max(model.scaleset[0][1]), query_tile_factor=3,
            entry_batch=TILED_BATCH, impl=impl)))
    cases += [(f"voxel_unique edge {edge}",
               lambda impl, edge=edge: multiscale._host_unique_voxels(
                   cloud, edge, bounds=model.bounds, impl=impl))
              for edge, _ in model.scaleset]
    cases.append(("parse_ascii", lambda impl: native.parse_ascii(
        text, impl=impl)))
    results = {}
    for what, fn in cases:
        native_ms, results[what] = _host_ms(lambda: fn("native"))
        numpy_ms, twin = _host_ms(lambda: fn("numpy"), 1)
        print(f"[native] {what}: bit-equal to the NumPy twin; host ms "
              f"native {native_ms:.3f}, numpy {numpy_ms:.3f}", flush=True)
        _check(_same_bits(results[what], twin),
               f"native {what} differs from its twin")
    # ties round up: half to even would give other steps on many rows
    even = np.round(ties.astype(np.float64) * 64)
    moved = (even != results["quantize_u16 ties"][:len(ties)]).any(1).mean()
    print(f"[native] tie cloud: {moved:.4f} of rows round otherwise half "
          "to even", flush=True)
    _check(moved > 0.3, "the tie cloud has no ties")

    model.stage(cloud)                         # sizes and caches the specs
    rows = []
    for c in clouds:
        staged = {}
        for impl in ("numpy", "native", "native", "numpy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = model.stage(c, impl=impl)
            torch.cuda.synchronize()
            staged.setdefault(impl, []).append(
                (1e3 * (time.perf_counter() - t0), st["query"]))
        _check(all(torch.equal(q, staged["numpy"][0][1])
                   for impl in staged for _, q in staged[impl]),
               "stage uploads differ between native and numpy")
        rows.append(tuple(min(ms for ms, _ in staged[impl])
                          for impl in ("numpy", "native")))
    print("[native] stage of the packed model, host ms to synchronize "
          "(numpy twin, native; least of two each): "
          + "; ".join(f"{a:.3f}, {b:.3f}" for a, b in rows), flush=True)


def _designated_phase(model, cloud, truth, device, profile_dir=None):
    """Designated-search streamed serving (the reference's
    ``scripts/bench_designated.py``): the fitted packed model's
    ``stage_search`` of the fit cloud (a copy, so no query is the map
    itself), overflow 0; three clouds (the cloud, then two 1 cm jitters
    of it from ``default_rng(7)``) through ``predict_stream``, counted
    from zero: only the plain ``packed_moments`` launched; labels equal
    to the per-cloud ``stage(c, search=map)`` labels exactly, accuracy
    > 0.8, every counter 0; then the handle's steps one at a time
    (staging plus ``predict_staged`` to synchronize), and the stream's
    wall time per cloud against that sequential loop's; with a
    ``profile_dir``, three handle steps profiled (staged before the
    window).  Then the small designated runs (``_designated_small``).
    Returns the launches a step."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.pipeline import COUNTERS

    search = cloud.copy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = model.stage_search(search)
    torch.cuda.synchronize()
    handle_s = time.perf_counter() - t0
    overflow = model.search_overflow(handle)
    _check(overflow == {"vox_dropped": 0, "interp_dropped": 0},
           f"designated map overflow {overflow}")
    rng = np.random.default_rng(7)
    clouds = [cloud] + [(cloud + rng.normal(0, 0.01, cloud.shape))
                        .astype(np.float32) for _ in range(2)]
    list(model.predict_stream(clouds, staged_search=handle))     # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    streamed = list(model.predict_stream(clouds, staged_search=handle))
    torch.cuda.synchronize()
    stream_ms = 1e3 * (time.perf_counter() - t0) / len(clouds)
    counts = _counts()
    _only(counts, ("packed_moments",), "the designated stream")
    _check(counts["packed_moments"] > 0, "the designated stream launched "
           "no packed_moments")
    steps, diags, distinct_ms = [], [], []
    for c, got in zip(clouds, streamed):
        t0 = time.perf_counter()
        staged = model.stage(c, staged_search=handle)
        t1 = time.perf_counter()
        labels, diag = model.predict_staged(staged, with_diag=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.append((1e3 * (t2 - t0), 1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        diags.append({k: int(v) for k, v in diag.items()})
        t0 = time.perf_counter()
        distinct = model.predict_staged(model.stage(c, search=search))
        torch.cuda.synchronize()
        distinct_ms.append(1e3 * (time.perf_counter() - t0))
        _check(torch.equal(got, labels) and torch.equal(got, distinct),
               "designated labels differ: stream, staged handle and "
               "stage(c, search=map) must agree exactly")
    accs = _check_served("designated", diags,
                         [g.cpu() for g in streamed], [truth] * len(clouds))
    _check(set(diags[0]) == set(COUNTERS), f"counters {diags[0]}")
    sequential_ms = sum(t for t, _, _ in steps) / len(steps)
    per_step = counts["packed_moments"] / len(clouds)
    print(f"[designated] stage_search {handle_s:.3f} s, overflow "
          f"{overflow}; stream of {len(clouds)} clouds: "
          f"{per_step:g} packed_moments launches a step, wall "
          f"{stream_ms:.3f} ms a cloud against {sequential_ms:.3f} ms a "
          f"step one at a time; steps ms (total, stage, predict+sync): "
          f"{_steps_text(steps)}; stage(c, search=map) + predict_staged "
          "ms: " + ", ".join(f"{t:.3f}" for t in distinct_ms)
          + "; labels equal to it; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs) + f"; counters {diags}; "
          f"launches {counts}", flush=True)
    if profile_dir:
        staged = [model.stage(c, staged_search=handle) for c in clouds]
        _profile_phase("[profile designated]", "serving_designated",
                       [lambda s=s: model.predict_staged(s)
                        for s in staged], profile_dir)
    _designated_small(device)
    return per_step


def _designated_small(device):
    """Designated search at E2E_POINTS: ``sazo`` and ``vector`` fitted
    against a copy of the cloud as the map (``vector`` with the bench
    attributes on the map), served through a handle, each counted from
    zero (only the sazo instance; only the attribute instance, the
    interp having run at ``stage_search``): labels equal to
    ``stage(c, search=map)``'s, counters 0, accuracy > 0.8.  Then
    ``minimal`` on the card against the same classifier on the CPU,
    each through its own handle: labels differ only at near-ties, at
    most MAX_FLIPS."""
    import torch
    from nimrud_tpu_torch.utils import checks, workload

    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, other_labels = workload.make_bench_cloud(E2E_POINTS, seed=1)
    search = small.copy()
    for kind, mine in (("sazo", ("packed_moments_sazo",)),
                       ("vector", ("packed_moments_attr",))):
        attrs = workload.make_bench_attributes(small_labels) \
            if kind == "vector" else None
        model = workload.make_bench_model(small, kind=kind, device=device)
        model.fit(small, small_labels, search=search,
                  sample=E2E_POINTS // 2, attributes=attrs)
        handle = model.stage_search(search, attributes=attrs)
        overflow = model.search_overflow(handle)
        torch.cuda.synchronize()
        _reset_counts()
        labels, diag = model.predict_staged(
            model.stage(small, staged_search=handle), with_diag=True)
        torch.cuda.synchronize()
        counts = _counts()
        distinct = model.predict_staged(model.stage(small, search=search,
                                                    attributes=attrs))
        _check(torch.equal(labels, distinct), f"designated {kind}: handle "
               "labels differ from stage(c, search=map)'s")
        diag = {k: int(v) for k, v in diag.items()}
        accs = _check_served(f"designated {kind}", [diag], [labels.cpu()],
                             [small_labels])
        _check(overflow == {"vox_dropped": 0, "interp_dropped": 0},
               f"designated {kind} map overflow {overflow}")
        _only(counts, mine, f"designated {kind}")
        _check(all(counts[k] > 0 for k in mine), f"designated {kind}: "
               f"{mine} did not run")
        print(f"[designated] {kind} at {E2E_POINTS}: labels equal to "
              f"stage(c, search=map)'s; accuracy {accs[0]:.4f}; counters "
              f"{diag}; map overflow {overflow}; launches {counts}",
              flush=True)
    gpu = workload.make_bench_model(small, device=device)
    gpu.fit(small, small_labels, search=search, sample=E2E_POINTS // 2)
    cpu = workload.make_bench_model(small, device="cpu")
    cpu.install_classifier(checks.on_cpu(gpu.classifier), small,
                           search=search)
    g_lab, g_prob = gpu.predict_staged(
        gpu.stage(other, staged_search=gpu.stage_search(search)),
        with_proba=True)
    t0 = time.perf_counter()
    c_lab = cpu.predict_staged(cpu.stage(other,
                                         staged_search=cpu.stage_search(
                                             search)))
    cpu_s = time.perf_counter() - t0
    near_tie = _top2_gap(g_prob.cpu()) < TIE_GAP
    differ = g_lab.cpu() != c_lab
    print(f"[designated] minimal card vs cpu at {E2E_POINTS}: "
          f"{int(differ.sum())} labels differ, {int(near_tie.sum())} "
          f"near-ties; cpu serve {cpu_s:.2f} s", flush=True)
    _check(not bool((differ & ~near_tie).any()),
           "designated: card and cpu labels differ away from near-ties")
    _check(int(differ.sum()) <= MAX_FLIPS * E2E_POINTS,
           "designated: too many label flips")


def _chunking(model, cloud):
    """Sizes the serving specs of ``cloud`` (the host work a first
    ``stage`` of its size bucket does) and returns (seconds, e_cap,
    q_cap, entries a chunk or None, chunks)."""
    from nimrud_tpu_torch import pipeline
    t0 = time.perf_counter()
    specs = model._fused_band_specs(cloud, cloud)
    sizing_s = time.perf_counter() - t0
    pack = min((band.dev_spec for band in specs),
               key=lambda spec: spec.tile_edge)
    chunk = pipeline._serving_entry_chunk(pack.e_cap, pack.q_cap,
                                          model.serving_chunk_slots)
    n_chunks = 1 if chunk is None else -(-pack.e_cap // chunk)
    return sizing_s, pack.e_cap, pack.q_cap, chunk, n_chunks


def _served_problems(model, cloud, device, index=0, pick=None):
    """Band ``index``'s kernel inputs on the packed serving path, as
    ``fused_extract_packed_multi`` forms them: the shared plan on the
    pack grid, the band's spans against it, then in each entry chunk
    (one chunk where the step is un-chunked) the capacity buckets split
    within the chunk at the band's capacities (entries past the live
    ones, which e_cap's estimate leaves, run as dead lanes).
    ``pick(chunk, e_cap, plan)`` gives the starts of the chunks to keep
    (default every chunk).  Returns ``[((lo, hi), (q_t, cand_t,
    centers), radii)]`` a bucket."""
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.ops import device_grid

    band, query, valid, centers, mask = _staged_band(model, cloud, device,
                                                     index)
    pack = min((b.dev_spec for b in model._fused_band_specs(cloud, cloud)),
               key=lambda spec: spec.tile_edge)
    chunk = pipeline._serving_entry_chunk(
        pack.e_cap, pack.q_cap, model.serving_chunk_slots) or pack.e_cap
    plan = device_grid._pack_plan(query, valid, pack)
    spans = device_grid._band_spans(plan, centers, mask, band.dev_spec,
                                    presorted=True)
    sorted3 = device_grid._far_extended(spans["sorted_pts"])
    starts = range(0, pack.e_cap, chunk) if pick is None \
        else pick(chunk, pack.e_cap, plan)
    problems = []
    for lo in starts:
        hi = min(lo + chunk, pack.e_cap)
        buckets, _ = device_grid._bucket_problems(
            plan["q_t"][lo:hi], plan["centers"][lo:hi],
            spans["span_starts"][lo:hi], spans["span_lens"][lo:hi], sorted3,
            band.c_cap)
        problems += [((lo, hi), b[:3], band.radii) for b in buckets]
    return problems


def _chunk_problems(model, cloud, device):
    """Band 0's kernel inputs on the chunked serving path
    (:func:`_served_problems`): the capacity buckets of the first entry
    chunk, of the chunk holding the last live entry and of the last
    (ragged) chunk."""
    def ends(chunk, e_cap, plan):
        last_live = int((plan["count"] > 0).nonzero().max())
        return sorted({0, last_live // chunk * chunk,
                       (e_cap - 1) // chunk * chunk})
    return _served_problems(model, cloud, device, pick=ends)


def _large_phase(device):
    """The reference's ``scripts/bench_large.py`` workload: the 10M-point
    tile (``make_bench_cloud(10_000_000, seed=1)``), the bench model fit
    on a stride over its first 9M points, served in entry chunks at the
    default ``_CHUNK_SLOTS`` (three label steps counted from zero, then
    one with probabilities), ``packed_moments`` held against its twin at
    the chunked path's band-0 buckets (``_chunk_problems``), then served
    by a second model with the same classifier and un-chunked slots:
    feature rows bit-equal, labels equal, probabilities within
    ``checks.CHUNK_PROBA_TOLERANCE``."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    from nimrud_tpu_torch.pipeline import COUNTERS
    from nimrud_tpu_torch.utils import checks, workload

    t0 = time.perf_counter()
    cloud, labels = workload.make_bench_cloud(N_LARGE, seed=1)
    fit_cloud, fit_labels = cloud[:9 * N_LARGE // 10:9], \
        labels[:9 * N_LARGE // 10:9]
    model = workload.make_bench_model(cloud, device=device)
    model.fit(fit_cloud, fit_labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sizing_s, e_cap, q_cap, chunk, n_chunks = _chunking(model, cloud)
    print(f"[large] {N_LARGE} points (cloud and fit on {len(fit_cloud)}: "
          f"{fit_s:.2f} s); host sizing {sizing_s:.2f} s; e_cap {e_cap}, "
          f"q_cap {q_cap}: {e_cap * q_cap} slots, {chunk} entries a chunk, "
          f"{n_chunks} chunks", flush=True)
    _check(chunk is not None and n_chunks >= 2,
           f"the 10M tile serves in {n_chunks} chunk(s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    steps, served, _, diags = _serve(model, [cloud] * 3)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    accs = _check_served("large", diags, served, [labels] * 3)
    held = float((served[0][-1_000_000:].numpy()
                  == labels[-1_000_000:]).mean())
    _only(counts, ("packed_moments",), "the large step")
    _check(counts["packed_moments"] > 0, "the kernel did not run in the "
           "large step")
    print(f"[large] chunked steps ms (total, stage, predict+sync): "
          f"{_steps_text(steps)}; {counts['packed_moments'] / 3:g} "
          f"packed_moments launches a step; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs)
          + f", held out on the last 1M {held:.4f}; counters {diags[0]}; "
          f"peak {peak_gb:.3f} GiB", flush=True)
    staged = model.stage(cloud)
    labels_c, probs_c = model.predict_staged(staged, with_proba=True)
    feats_c = checks.served_features(model, staged).cpu()
    del staged
    for (lo, hi), (q_t, cand_t, cen), rr in _chunk_problems(model, cloud,
                                                            device):
        shape = (f"chunk [{lo}, {hi}): E={q_t.shape[0]} q_cap="
                 f"{q_t.shape[2]} c_cap={cand_t.shape[1] // q_t.shape[0]} "
                 f"radii={len(rr)}")
        rec = _hold(
            f"packed_moments large {shape}",
            lambda p: pm.packed_moments(q_t, cand_t, cen, rr, precision=p),
            lambda p: pm.packed_moments_plain(q_t, cand_t, cen, rr,
                                              precision=p),
            lambda ref: pm.moment_tolerance(ref, cand_t, cen))
        work = pm.packed_moments_work(q_t, cand_t, cen, rr)
        print(f"[kernel] packed_moments large {shape}: "
              f"{_work_text(rec, work)}", flush=True)
    del q_t, cand_t, cen

    whole = workload.make_bench_model(cloud, device=device,
                                      serving_chunk_slots=2 ** 62)
    whole.install_classifier(model.classifier, fit_cloud)
    del model
    sizing_w, _, _, chunk_w, _ = _chunking(whole, cloud)
    _check(chunk_w is None, "the un-chunked model chunks")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_w, served_w, _, diags_w = _serve(whole, [cloud])
    peak_w = torch.cuda.max_memory_allocated() / 2**30
    _check(all(diags_w[0][k] == 0 for k in COUNTERS),
           f"un-chunked counters {diags_w}")
    staged = whole.stage(cloud)
    labels_w, probs_w = whole.predict_staged(staged, with_proba=True)
    feats_w = checks.served_features(whole, staged).cpu()
    same = bool(torch.equal(labels_c, labels_w))
    err = float((probs_c - probs_w).abs().max())
    rows = int((feats_c != feats_w).any(1).sum())
    print(f"[large] served feature rows chunked against un-chunked: {rows} "
          f"of {N_LARGE} differ, the largest difference "
          f"{float((feats_c - feats_w).abs().max()):.3g}", flush=True)
    print(f"[large] un-chunked: host sizing {sizing_w:.2f} s; step ms "
          f"{_steps_text(steps_w)}; peak {peak_w:.3f} GiB against "
          f"{peak_gb:.3f} GiB chunked; labels equal to the chunked step's: "
          f"{same} ({int((labels_c != labels_w).sum())} differ); "
          f"probabilities bit-equal: {bool(torch.equal(probs_c, probs_w))}"
          f", largest difference {err:.3g}", flush=True)
    _check(rows == 0, "chunked and un-chunked feature rows differ")
    _check(same, "chunked and un-chunked labels differ")
    _check(err <= checks.CHUNK_PROBA_TOLERANCE, "chunked and un-chunked "
           "probabilities differ")
    _check(bool(np.isfinite(probs_c.cpu().numpy()).all()),
           "non-finite probabilities")
    return peak_gb * 2**30, peak_w * 2**30


def _levels_needed(tables, feats, max_depth):
    """Levels of the dense walk until every (tree, row) pair of ``feats``
    stands at a leaf: where an early exit would stop."""
    import torch
    n_trees, size, _ = tables["dense_vecs"].shape
    tag = torch.ones((n_trees, feats.shape[0]), dtype=torch.int64,
                     device=feats.device)
    done = torch.zeros_like(tag, dtype=torch.bool)
    tree = torch.arange(n_trees, device=feats.device)[:, None]
    for level in range(max_depth + 1):
        split = tables["dense_splits"][tree, tag]
        done |= torch.isinf(split)
        if bool(done.all()):
            return level + 1
        proj = (feats[None] * tables["dense_vecs"][tree, tag]).sum(2)
        tag = torch.where(done, tag, 2 * tag + (proj > split).long())
    return max_depth + 1


def _walk_hold(what, tables, feats, depth, d_func):
    """The forest walk kernel against its plain twin on one forest's
    dense ``tables`` (with their packing, ``forest_walk.pack_tables``)
    and feature rows, walked ``depth + 1`` levels: one
    launch; wherever the two differ in a probability by more than
    ``WALK_PROBA_TOLERANCE`` or in the label (a leaf taken on the other
    side of a split), the walk witness must hold the row near a split.
    Returns the rows that differ and the largest difference elsewhere."""
    import torch
    from nimrud_tpu_torch.ops.kernels import forest_walk as fw
    from nimrud_tpu_torch.utils import checks

    before = fw.forest_proba.launches
    got = fw.forest_proba(tables, feats, depth, d_func)
    torch.cuda.synchronize()
    _check(fw.forest_proba.launches == before + 1, f"{what}: no launch")
    want = fw.forest_proba_plain(tables, feats, depth, d_func)
    _check(bool(torch.isfinite(got).all()), f"{what}: non-finite answers")
    err = (got - want).abs().amax(1)
    off = (err > WALK_PROBA_TOLERANCE) | (got.argmax(1) != want.argmax(1))
    rows = off.nonzero()[:, 0]
    held = checks.walk_witness(tables, feats[rows].cpu(), depth,
                               torch.arange(len(rows)))
    _check(bool(held.all()), f"{what}: rows {rows.cpu()[~held][:8].tolist()}"
           " differ from the plain walk away from any split")
    return {"rows_off": len(rows),
            "max_abs_err": float(err[~off].max()) if bool((~off).any())
            else 0.0}


def _walk_draws(device):
    """The walk kernel against its twin on the drawn forests of
    ``WALK_DRAWS``, every instance width they reach and both decision
    functions."""
    from nimrud_tpu_torch.ops.kernels import forest_walk as fw
    from nimrud_tpu_torch.utils import checks

    lines = []
    for seed, (trees, depth, walk, dim, classes, d_func, rows) in \
            enumerate(WALK_DRAWS):
        tables, feats = checks.drawn_forest(seed, trees, depth, dim,
                                            classes, rows)
        tables = fw.pack_tables({k: v.to(device) for k, v in tables.items()})
        rec = _walk_hold(f"drawn forest {seed}", tables, feats.to(device),
                         walk, d_func)
        lines.append(f"{trees} trees, depth {depth}, {walk + 1} levels, D "
                     f"{dim} ({fw.instance(tables)}), C {classes}, "
                     f"{d_func}, {rows} rows: {rec['rows_off']} off, max "
                     f"err {rec['max_abs_err']:.3g}")
    print("[walk] drawn forests against the plain walk: "
          + "; ".join(lines), flush=True)


def _step_rows(model, staged):
    """The feature rows a serving step hands the classifier, chunk by
    chunk in the plan's slot order (the last, one zero row, is the
    scatter's)."""
    from nimrud_tpu_torch import pipeline

    classify, rows = pipeline.classify_features, []

    def capture(params, features):
        rows.append(features.clone())
        return classify(params, features)

    pipeline.classify_features = capture
    try:
        model.predict_staged(staged)
    finally:
        pipeline.classify_features = classify
    return rows


def _walk_phase(model, clouds, device):
    """The walk kernel on the rpte bench model: held against its twin on
    ``extract_device``'s rows of a served cloud and on the slot rows its
    serving step classifies, then on the drawn forests; a served scan
    launches it once an entry chunk and once for the scatter's zero row,
    also as the ``walk_launches`` counter of a traced scan, and a linear
    scan never (phase 4's count); timed on the step's rows beside its
    bound and the twin.  Returns the kernel record and its work."""
    import torch
    from nimrud_tpu_torch.ops.kernels import forest_walk as fw
    from nimrud_tpu_torch.utils import profiling

    forest = model.classifier
    tables = forest.walk_tables_
    depth, d_func = forest.walk_depth_, forest.d_func
    extracted = model.extract_device(clouds[0])
    rec = _walk_hold("extract_device rows", tables, extracted, depth, d_func)
    staged = model.stage(clouds[1])
    _, _, _, chunk, n_chunks = _chunking(model, clouds[1])
    before = fw.forest_proba.launches
    chunks = _step_rows(model, staged)
    launched = fw.forest_proba.launches - before
    _check(launched == n_chunks + 1 == len(chunks),
           f"a served rpte scan launched the walk {launched} times, "
           f"{n_chunks} entry chunks")
    rows = torch.cat(chunks[:-1])
    step = _walk_hold("the step's slot rows", tables, rows, depth, d_func)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        model.predict_staged(model.stage(clouds[2]))
    counted = profiling.collected()["counters"].get("walk_launches")
    profiling.reset()
    _check(counted == n_chunks + 1,
           f"a traced rpte scan counted walk_launches {counted}")
    _walk_draws(device)
    rec["max_abs_err"] = max(rec["max_abs_err"], step["max_abs_err"])
    rec["ms"] = _events_ms(lambda: fw.forest_proba(tables, rows, depth,
                                                   d_func), 20)
    rec["plain_ms"] = _events_ms(
        lambda: fw.forest_proba_plain(tables, rows, depth, d_func), 3)
    extract_ms = _events_ms(lambda: forest.proba_device(extracted), 20)
    work = fw.forest_walk_work(tables, rows, depth)
    print(f"[walk] {fw.instance(tables)} on the "
          f"step's {rows.shape[0]} slot rows ({n_chunks} chunk(s) of "
          f"{chunk or 'all'} entries; {launched} launches a scan, "
          f"walk_launches {counted} traced): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms; {work['pairs']} (row, tree) "
          f"pairs, {work['internal']} projections, {work['leaves']} "
          f"leaves, {work['row_bytes'] / 1e9:.3f} GB of table rows read "
          f"({work['table_bytes'] / 1e6:.2f} MB of them distinct); "
          f"bound {work['bound_ms']:.4f} ms ({work['bound_term']}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in work["terms_ms"].items())
          + f"), {100 * work['bound_ms'] / rec['ms']:.1f}% of bound; on "
          f"extract_device's {extracted.shape[0]} rows {extract_ms:.4f} ms; "
          f"rows off the plain walk {rec['rows_off']} / {step['rows_off']} "
          "(each held by the walk witness), largest difference elsewhere "
          f"{rec['max_abs_err']:.3g}", flush=True)
    return rec, work


def _rpte_phase(cloud, labels, clouds, truths, device, profile_dir=None):
    """The reference's ``scripts/bench_rpte.py`` workload: the bench model
    with ``classifier="rpte"`` (10 trees, ``wmean``, seed 0) fit on the
    device (``fit_device`` on a 100k sample) and serving the three 1M
    clouds, counted from zero; the forest walk alone timed on a step's
    feature rows; the walk kernel's holds, launches and time
    (``_walk_phase``); card against CPU at 100k (``_e2e_kind``); with a
    ``profile_dir`` three steps profiled with the walk's share.  Returns
    the walk kernel's record (with its launches in the three serving
    steps) and work."""
    import torch
    from nimrud_tpu_torch import pipeline
    from nimrud_tpu_torch.utils import checks, workload

    model = workload.make_bench_model(cloud, classifier="rpte",
                                      device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model.fit(cloud, labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = _counts()
    steps, served, _, diags = _serve(model, clouds)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    accs = _check_served("rpte", diags, served, truths)
    _only(counts, ("packed_moments", "forest_walk"), "the rpte path")
    _check(fit_counts["packed_moments"] > 0
           and counts["packed_moments"] > fit_counts["packed_moments"],
           "the kernel did not run in the rpte fit and serving")
    _check(counts["forest_walk"] > fit_counts["forest_walk"],
           "the walk kernel did not run in the rpte serving")
    forest = model.classifier
    staged = model.stage(clouds[0])
    feats = checks.served_features(model, staged)
    walk_ms = _events_ms(lambda: forest.proba_device(feats), 3)
    needed = _levels_needed(forest._tables, feats, forest.max_depth_)
    print(f"[rpte] fit {fit_s:.3f} s (fit_device, {forest.n_estimators} "
          f"trees, {forest.d_func}); serve steps ms (total, stage, "
          f"predict+sync): {_steps_text(steps)}; "
          f"{(counts['packed_moments'] - fit_counts['packed_moments']) / 3:g}"
          f" packed_moments launches a step; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; max_depth_ {forest.max_depth_}, "
          f"{forest.walk_depth_ + 1} levels walked a step (one past the "
          f"deepest split; {needed} needed "
          f"by the cloud's rows); the walk alone on the cloud's "
          f"{feats.shape[0]} served rows {walk_ms:.3f} ms (CUDA events); peak "
          f"{peak_gb:.3f} GiB; forest_walk launches "
          f"{(counts['forest_walk'] - fit_counts['forest_walk']) / 3:g} a "
          "step", flush=True)
    walk = _walk_phase(model, clouds, device)
    walk[0]["launches"] = counts["forest_walk"] - fit_counts["forest_walk"]
    if profile_dir:
        staged_all = [model.stage(c) for c in clouds]
        classify = pipeline.classify_features

        def annotated(params, features):
            with torch.profiler.record_function("rpt walk"):
                return classify(params, features)

        pipeline.classify_features = annotated
        try:
            _profile_phase("[profile rpte]", "serving_rpte",
                           [lambda st=st: model.predict_staged(st)
                            for st in staged_all], profile_dir,
                           annotation="rpt walk")
        finally:
            pipeline.classify_features = classify
    del model, staged, feats
    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, other_labels = workload.make_bench_cloud(E2E_POINTS, seed=1)
    _e2e_kind("minimal", small, small_labels, other, other_labels, device,
              classifier="rpte")
    return walk


def _knn_d2_bound(radius):
    """Bound on |f32 d2 - float64 d2| of the neighbor search's expanded
    form on the tiled problem of tile edge ``radius`` (query tiles of two
    search tiles): entry-local coordinates within L = sqrt(3) * 2 *
    radius of the entry center; each rounded local coordinate moves d2 by
    at most 2 |d| u L a coordinate, the three fused chains and the two
    sums by at most u (qq + ss + 2 |qs|) <= 4 u L^2 each -- 32 u L^2
    covers them."""
    span = math.sqrt(3.0) * 2.0 * radius
    return 32.0 * EPS32 * span * span


def _d2_64(cloud, rows, idx):
    """float64 squared distances of ``cloud[rows]`` to ``cloud[idx]``
    ((k, n) indices; -1 pads give inf)."""
    import numpy as np
    q = cloud[rows].astype(np.float64)[:, None, :]
    s = cloud[np.where(idx < 0, 0, idx)].astype(np.float64)
    return np.where(idx < 0, np.inf, ((q - s) ** 2).sum(-1))


def _knn_vs_scipy(cloud, got_knn, got_radius, bound):
    """The kNN and radius results of KNN_SAMPLE queries against scipy's
    cKDTree in float64.  kNN: each slot whose float64 neighbor lies
    within the horizon is the tree's (distance within 1e-4 or, for the
    nearest few millimetres, within the f32 bound; indices equal except
    at distance ties); beyond the horizon the search can only return a
    farther candidate.  Radius: counts equal except where a candidate
    lies within the bound of r^2; sets equal where counts agree and fit
    k_max; an overflowed query keeps the k_max nearest."""
    import numpy as np
    from scipy.spatial import cKDTree

    rows = np.random.default_rng(7).choice(len(cloud), KNN_SAMPLE,
                                           replace=False)
    tree = cKDTree(cloud.astype(np.float64))
    dist, idx = tree.query(cloud[rows].astype(np.float64), k=KNN_K)
    mine = got_knn["distances"][rows].astype(np.float64)
    mine_idx = got_knn["indices"][rows]
    inside = dist <= KNN_RADIUS
    close = (np.abs(mine - dist) <= 1e-4) \
        | (np.abs(mine ** 2 - dist ** 2) <= bound + 4 * EPS32 * dist ** 2)
    _check(bool(close[inside].all()), "knn: a distance within the horizon "
           "off the tree's")
    _check(bool(got_knn["valid"][rows][inside].all()), "knn: a neighbor "
           "within the horizon not found")
    swapped = inside & (mine_idx != idx)
    outside = ~inside & got_knn["valid"][rows]
    _check(bool((mine[outside] >= dist[outside] - 1e-4).all()),
           "knn: a neighbor beyond the horizon nearer than the tree's")
    r2 = KNN_RADIUS * KNN_RADIUS
    balls = tree.query_ball_point(cloud[rows].astype(np.float64),
                                  KNN_RADIUS)
    count = got_radius["count"][rows]
    boundary = mismatched = overflowed = 0
    for i, (row, ball) in enumerate(zip(rows, balls)):
        if count[i] != len(ball):
            # only candidates within the bound of r^2 may count otherwise
            near = tree.query_ball_point(cloud[row].astype(np.float64),
                                         math.sqrt(r2 + bound))
            gap = np.abs(((cloud[near].astype(np.float64)
                           - cloud[row].astype(np.float64)) ** 2).sum(1)
                         - r2)
            _check(abs(int(count[i]) - len(ball))
                   <= int((gap <= bound).sum()),
                   f"radius: query {row} counts {count[i]} against the "
                   f"tree's {len(ball)} with no candidate at the boundary")
            boundary += 1
            continue
        kept = got_radius["indices"][row][got_radius["valid"][row]]
        if count[i] <= KNN_K_MAX:
            mismatched += set(kept.tolist()) != set(ball)
        else:
            overflowed += 1
            nearest = np.sort(((cloud[ball].astype(np.float64)
                                - cloud[row].astype(np.float64)) ** 2
                               ).sum(1))[:KNN_K_MAX]
            ours = np.sort(got_radius["distances"][row].astype(
                np.float64) ** 2)
            _check(bool((np.abs(ours - nearest) <= bound
                         + 4 * EPS32 * nearest).all()),
                   f"radius: overflowed query {row} did not keep the "
                   f"{KNN_K_MAX} nearest")
    _check(mismatched == 0, f"radius: {mismatched} neighbor sets differ "
           "from the tree's")
    return {"knn slots in the horizon": int(inside.sum()),
            "knn ties swapped": int(swapped.sum()),
            "knn slots past the horizon": int(outside.sum()),
            "radius counts at the boundary": boundary,
            "radius overflowed": overflowed}


def _knn_card_vs_cpu(small, device, bound):
    """The kNN and radius searches of a 100k cloud on the card and on the
    CPU: indices equal, each difference witnessed (the two candidates'
    float64 d2 within twice the f32 bound of each other).  Returns the
    differing slots and the CPU seconds."""
    import numpy as np
    from nimrud_tpu_torch.ops import neighbors

    out = {}
    for mode, k in (("knn", KNN_K), ("radius", KNN_K_MAX)):
        card = neighbors.neighbor_search(small, small, k, KNN_RADIUS, mode,
                                         device)
        t0 = time.perf_counter()
        cpu = neighbors.neighbor_search(small, small, k, KNN_RADIUS, mode,
                                        "cpu")
        cpu_s = time.perf_counter() - t0
        a, b = card["indices"].cpu().numpy(), cpu["indices"].numpy()
        _check(np.array_equal(card["count"].cpu().numpy(),
                              cpu["count"].numpy()), f"{mode}: card and cpu "
               "counts differ")
        same = a == b
        _check(np.array_equal(card["distances"].cpu().numpy()[same],
                              cpu["distances"].numpy()[same]),
               f"{mode}: card and cpu distances of the same neighbor "
               "differ")
        rows = np.nonzero((a != b).any(1))[0]
        if len(rows):
            with np.errstate(invalid="ignore"):
                gap = np.abs(_d2_64(small, rows, a[rows])
                             - _d2_64(small, rows, b[rows]))
            gap = np.where(a[rows] == b[rows], 0.0, gap)
            _check(bool((gap <= 2 * bound).all()), f"{mode}: card and cpu "
                   "indices differ beyond the f32 bound")
        out[mode] = (int((a != b).sum()), cpu_s)
    return out


def _knn_phase(device):
    """Phase 12: ``knn_features`` (``minimal``, ``eigen``) and the kNN and
    radius searches of the 1M bench cloud against itself on the card,
    counted from zero (no moment kernel runs); each timed to synchronize
    with its entry batches, sub-batches and peak memory; then held
    against scipy's cKDTree on KNN_SAMPLE queries and against the CPU
    at E2E_POINTS."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.features import knn as fknn
    from nimrud_tpu_torch.ops import neighbors
    from nimrud_tpu_torch.utils import workload

    cloud, _ = workload.make_bench_cloud(N_POINTS, seed=0)
    bound = _knn_d2_bound(KNN_RADIUS)
    _reset_counts()
    got = {}

    def timed(name, fn):
        """``fn()`` to synchronize, its time and peak memory printed with
        the search's stats (``knn_features`` searches as ``knn`` does:
        the same tiled problem)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"[knn] {name}: {time.perf_counter() - t0:.3f} s to "
              f"synchronize; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        return out

    def search(mode, k):
        res = neighbors.neighbor_search(cloud, cloud, k, KNN_RADIUS, mode,
                                        device)
        stats = res.pop("stats")
        print(f"[knn] {mode} search: {stats['entries']} entries, "
              f"{stats['entry_batches']} entry batches of "
              f"{neighbors.ENTRY_BATCH}, {stats['sub_batches']} sub-batches, "
              f"q_cap {stats['q_cap']}, {stats['lanes']} candidate lanes an "
              f"entry compacted to at most {stats['max_width']}, "
              f"{stats['pairs']} pairs", flush=True)
        return {key: v.cpu().numpy() for key, v in res.items()}

    for kind in ("minimal", "eigen"):
        got[kind] = timed(f"knn_features {kind} (k {KNN_K}, horizon "
                          f"{KNN_RADIUS})", lambda: fknn.knn_features(
                              cloud, cloud, KNN_K, KNN_RADIUS, kind,
                              device))
        _check(np.isfinite(got[kind]).all() and got[kind].shape
               == (N_POINTS, 4 if kind == "minimal" else 10),
               f"knn_features {kind}: shape or non-finite values")
    got["knn"] = timed(f"knn (k {KNN_K})", lambda: search("knn", KNN_K))
    got["radius"] = timed(f"radius_neighbors (r {KNN_RADIUS}, k_max "
                          f"{KNN_K_MAX})", lambda: search("radius",
                                                          KNN_K_MAX))
    _only(_counts(), (), "the knn path")
    over = float((got["radius"]["count"] > KNN_K_MAX).mean())
    short = float((got["knn"]["valid"].sum(1) < KNN_K).mean())
    print(f"[knn] radius overflowed share {over:.4f}; kNN rows with fewer "
          f"than {KNN_K} candidates in their tiles {short:.4f}; counts of "
          f"knn_features minimal equal to the search's valid slots: "
          f"{bool((got['minimal'][:, 0] == got['knn']['valid'].sum(1)).all())}",
          flush=True)
    _check(bool((got["minimal"][:, 0] == got["knn"]["valid"].sum(1)).all()),
           "knn_features counts differ from the search's valid slots")
    t0 = time.perf_counter()
    found = _knn_vs_scipy(cloud, got["knn"], got["radius"], bound)
    print(f"[knn] against scipy cKDTree on {KNN_SAMPLE} queries (f32 d2 "
          f"bound {bound:.3g} m^2): {found} ({time.perf_counter() - t0:.1f}"
          " s)", flush=True)
    small, _ = workload.make_bench_cloud(E2E_POINTS, seed=0)
    for mode, (differ, cpu_s) in _knn_card_vs_cpu(small, device,
                                                  bound).items():
        print(f"[knn] card vs cpu {mode} at {E2E_POINTS}: counts equal, "
              f"{differ} index slots differ (each within twice the f32 "
              f"bound), the distances of equal slots bit-equal; cpu "
              f"{cpu_s:.2f} s", flush=True)


def _host_classifiers():
    """(name, factory) of the host classifiers phase 13 runs: the NumPy
    nearest mean (``checks.NearestMean``) always, sklearn's ``rf``
    where sklearn imports."""
    from nimrud_tpu_torch.learning.classifiers import param_classifier
    from nimrud_tpu_torch.utils.checks import NearestMean
    runs = [("nearest-mean", NearestMean)]
    try:
        import sklearn
    except ImportError:
        print("[host] sklearn: not importable", flush=True)
        return runs
    print(f"[host] sklearn {sklearn.__version__}", flush=True)
    return runs + [("rf", lambda: param_classifier("rf", n_estimators=10))]


def _host_e2e(name, factory, device):
    """A host-classifier model fit at E2E_POINTS on the card, the same
    classifier on the CPU: each differing label held by
    ``_rounding_witness`` (every feature of the row within its f32
    bound of a float64 oracle)."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.utils import workload

    small, small_labels = workload.make_bench_cloud(E2E_POINTS, seed=0)
    other, _ = workload.make_bench_cloud(E2E_POINTS, seed=1)
    gpu = workload.make_bench_model(small, classifier=factory(),
                                    device=device)
    gpu.fit(small, small_labels, sample=E2E_POINTS // 2)
    cpu = workload.make_bench_model(small, device="cpu")
    cpu.install_classifier(gpu.classifier, small)
    g_lab = gpu.predict_device(other).cpu()
    g_feats = gpu.extract_device(other).cpu()
    t0 = time.perf_counter()
    c_feats = cpu.extract_device(other)
    c_lab = cpu._classify(c_feats).argmax(1).to(torch.int32)
    cpu_s = time.perf_counter() - t0
    _check(torch.equal(gpu._classify(g_feats).argmax(1).to(torch.int32)
                       .cpu(), g_lab), f"host e2e {name}: card labels are "
           "not its rows'")
    differ = g_lab != c_lab
    rows = differ.nonzero()[:, 0]
    held, ratio = torch.ones(0, dtype=torch.bool), 0.0
    if len(rows):
        q_bucket = multiscale._pow2_bucket(len(other))
        staged = {"query": torch.from_numpy(multiscale._pad_rows_f32(
                      other, q_bucket)),
                  "dequant": None, "n_query": len(other),
                  "specs": tuple(_fit_specs(cpu, other)),
                  "band_plans": True}
        held, ratio = _rounding_witness("minimal", cpu, staged, rows,
                                        g_feats, c_feats)
    print(f"[host] {name} card vs cpu at {E2E_POINTS}: {int(differ.sum())} "
          f"labels differ, {int(held.sum())} held by the rounding witness "
          f"(largest feature difference {ratio:.4g} of its bound), "
          f"{int((g_feats != c_feats).any(1).sum())} feature rows differ; "
          f"cpu extract {cpu_s:.2f} s", flush=True)
    _check(bool(held.all()), f"host e2e {name}: labels differ without the "
           "rounding witness")
    _check(int(differ.sum()) <= MAX_FLIPS * E2E_POINTS,
           f"host e2e {name}: too many label flips")


def _host_phase(fit_cloud, fit_labels, clouds, truths, device, peaks):
    """Phase 13: the bench model with a host classifier (``_host_
    classifiers``) fit on the bench fit cloud (``sample=100_000``) and
    predicting the three 1M clouds through ``predict_device`` (counted
    from zero: only ``packed_moments``), its ``stage`` raising, its labels
    the argmax of the float32 cast of ``predict_proba`` on its own
    ``extract`` rows; card against CPU at E2E_POINTS (``_host_e2e``).
    Then ``utils.memory.projected_fused_bytes`` beside ``peaks``, the
    measured peak bytes of the 1M packed fit and step and the 10M
    step."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.pipeline import COUNTERS
    from nimrud_tpu_torch.utils import memory, workload

    for name, factory in _host_classifiers():
        model = workload.make_bench_model(fit_cloud, classifier=factory(),
                                          device=device)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        model.fit(fit_cloud, fit_labels, sample=FIT_SAMPLE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts = _counts()
        steps, served, diags = [], [], []
        for cloud in clouds:
            t0 = time.perf_counter()
            labels, diag = model.predict_device(cloud, with_diag=True)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t0))
            served.append(labels.cpu())
            diags.append({k: int(v) for k, v in diag.items()})
        counts = _counts()
        accs = _check_served(f"host {name}", diags, served, truths)
        _only(counts, ("packed_moments",), f"the host {name} path")
        launches = counts["packed_moments"] - fit_counts["packed_moments"]
        _check(fit_counts["packed_moments"] > 0 and launches > 0,
               f"host {name}: the kernel did not run in fit and predict")
        try:
            model.stage(clouds[0])
            raised = False
        except ValueError:
            raised = True
        _check(raised, f"host {name}: stage did not raise")
        # one call's parts: the extraction on the card, the host round trip
        t0 = time.perf_counter()
        feats = model.extract_device(clouds[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model._classify(feats)
        torch.cuda.synchronize()
        parts = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
        want = np.asarray(model.classifier.predict_proba(
            feats.cpu().numpy()), np.float32).argmax(1)
        same = bool(np.array_equal(served[0].numpy(), want))
        fit_launches = fit_counts["packed_moments"]
        print(f"[host] {name}: fit {fit_s:.3f} s ({fit_launches} "
              "packed_moments launches); predict_device ms "
              + ", ".join(f"{t:.1f}" for t in steps)
              + f" ({launches / len(clouds):g} launches a call; of a call "
              f"{parts[0]:.1f} ms extract_device to synchronize, "
              f"{parts[1]:.1f} ms the host round trip of _classify); "
              "accuracy "
              + ", ".join(f"{a:.4f}" for a in accs)
              + f"; counters {diags[0]}; stage raises; labels equal to the "
              f"argmax of f32 predict_proba of extract: {same}", flush=True)
        _check(same, f"host {name}: served labels are not the classifier's "
               "on the model's own rows")
        _host_e2e(name, factory, device)
        del model
    scaleset = [(edge, radii) for edge, radii in workload.make_bench_model(
        fit_cloud, device="cpu").scaleset]
    span = fit_cloud.max(0) - fit_cloud.min(0)
    for what, n, peak in peaks:
        proj = memory.projected_fused_bytes(n, n, scaleset, bounds_span=span)
        print(f"[host] memory: projected_fused_bytes({n}) {proj / 2**30:.3f}"
              f" GiB against the measured peak of the {what} "
              f"{peak / 2**30:.3f} GiB: "
              f"{'an upper bound' if proj >= peak else 'BELOW the peak'}",
              flush=True)
        _check(proj >= peak, f"projected_fused_bytes is below the {what}'s "
               "measured peak")
    print(f"[host] device_hbm_budget {memory.device_hbm_budget(device) / 2**30:.3f}"
          " GiB", flush=True)


def _cli(args, device):
    """``nimrud_tpu_torch.cli.main(args)`` in process on ``device``: its
    printed JSON and its seconds."""
    import contextlib
    import io
    import torch
    from nimrud_tpu_torch import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["--device", str(device)] + list(args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return json.loads(out.getvalue()), seconds


@contextlib.contextmanager
def _timed(owner, names, seconds):
    """Wrap methods ``names`` of class ``owner`` for the block: the
    seconds of their outermost calls add up in ``seconds[name]``."""
    import torch
    depth = [0]
    saved = {name: getattr(owner, name) for name in names}

    def wrap(name, method):
        def timed(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return method(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    torch.cuda.synchronize()
                    seconds[name] = seconds.get(name, 0.0) \
                        + time.perf_counter() - t0
        return timed

    for name, method in saved.items():
        setattr(owner, name, wrap(name, method))
    try:
        yield seconds
    finally:
        for name, method in saved.items():
            setattr(owner, name, method)


def _workflow_features(arc, device):
    """Phase 14's ``features`` runs: the fused extraction (only
    ``packed_moments``, rows bit-equal to a direct extraction) and the
    partition loop (no moment kernel, populations against it).  Returns
    the fused run's launches."""
    import numpy as np
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.utils import memory, workload
    from nimrud_tpu_torch.workflows import features as wf_features

    scaleset = [(edge, (radius,)) for edge, radius in
                zip(workload.BENCH_EDGES, workload.BENCH_RADII)]
    scales = [f"{edge:g}:{radius:g}" for edge, (radius,) in scaleset]
    _reset_counts()
    out, feat_s = _cli(["features", arc, "--scales", *scales, "--kind",
                        "minimal", "--name", "mso"], device)
    counts = _counts()
    _check(out == {"feature_asset": "mso"}, f"features printed {out}")
    _only(counts, ("packed_moments",), "the features workflow")
    launches = counts["packed_moments"]
    _check(launches > 0, "features: packed_moments did not run")
    archive = CloudArchive.open(arc)
    stored, index, meta = archive.get_asset("mso")
    points = archive.take(original_coordinates=False).astype(np.float32)
    t0 = time.perf_counter()
    direct, stats = multiscale.extract_scaleset_device(
        points, points, scaleset, "minimal", with_stats=True, device=device)
    direct = direct.cpu().numpy()
    direct_s = time.perf_counter() - t0
    stats = {k: int(v) for k, v in stats.items()}
    same = bool(np.array_equal(stored, direct))
    print(f"[workflows] features --kind minimal (3 bands) at {len(points)}: "
          f"{feat_s:.3f} s, {launches} packed_moments launches, no other "
          f"kernel; stored {stored.shape} rows bit-equal to a direct "
          f"extract_scaleset ({direct_s:.3f} s, counters {stats}): {same}",
          flush=True)
    _check(np.array_equal(index, np.arange(len(points))) and same,
           "features: stored rows differ from the direct extraction")
    _check(all(v == 0 for v in stats.values()), f"features counters {stats}")
    _check(meta["kind"] == "minimal", f"features meta {meta}")

    span = points.max(0) - points.min(0)
    decision = memory.auto_partition_population(
        len(points), len(points), scaleset, bounds_span=span, device=device)
    print(f"[workflows] auto_partition_population at {len(points)} on this "
          f"card ({memory.device_hbm_budget(device) / 2**30:.3f} GiB "
          f"budget): {decision}", flush=True)
    _check(decision is None, "the 1M bench does not fit the card in one "
           "piece")
    calls = collections.Counter()
    extract = wf_features.extract_scaleset

    def counted(query, search, bands, *args, **kwargs):
        calls[bands[0][1]] += 1
        return extract(query, search, bands, *args, **kwargs)

    wf_features.extract_scaleset = counted
    _reset_counts()
    try:
        out, part_s = _cli(["features", arc, "--scales", *scales, "--kind",
                            "minimal", "--name", "parts", "--partition-max",
                            str(PARTITION_MAX)], device)
    finally:
        wf_features.extract_scaleset = extract
    counts = _counts()
    _only(counts, (), "the partitioned features workflow")
    parts, _, _ = archive.get_asset("parts")
    pops = slice(0, None, 4)
    agree = float((parts[:, pops] == stored[:, pops]).all(1).mean())
    print(f"[workflows] features --partition-max {PARTITION_MAX}: "
          f"{part_s:.3f} s, partitions a band "
          + ", ".join(f"r {r[0]:g}: {calls[r]}" for _, r in scaleset)
          + f"; no moment kernel; populations equal to the fused run's at "
          f"{agree:.6f} of points", flush=True)
    _check(agree >= MIN_POP_AGREE, "partitioned features: populations "
           f"agree at {agree}")
    return launches


def _workflow_train(arc, truth, device):
    """Phase 14's ``train`` (rpte, linear), ``evaluate`` and ``export``
    runs, with the fit and apply seconds of each classifier."""
    import numpy as np
    from nimrud_tpu_torch.archive import io as cloud_io
    from nimrud_tpu_torch.archive.store import CloudArchive
    from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
    from nimrud_tpu_torch.learning.rpt import RPTEnsemble
    from nimrud_tpu_torch.workflows import viz

    for classifier, owner, name in (("rpte", RPTEnsemble, "pred"),
                                    ("linear", SoftmaxClassifier,
                                     "pred_lin")):
        seconds = {}
        with _timed(owner, ("fit", "predict", "predict_proba"), seconds):
            out, train_s = _cli([
                "train", arc, "--features", "mso", "--classifier",
                classifier, "--classifier-kwargs", '{"seed": 0}',
                "--samples-per-class", str(WORKFLOW_SAMPLES), "--name",
                name], device)
        apply_s = seconds.get("predict", 0.0) \
            + seconds.get("predict_proba", 0.0)
        print(f"[workflows] train --classifier {classifier} "
              f"--samples-per-class {WORKFLOW_SAMPLES}: {train_s:.3f} s (fit "
              f"{seconds['fit']:.3f} s on the host rows, apply "
              f"{apply_s:.3f} s: validation and the {len(truth)} rows, "
              f"labels and probabilities); validation accuracy "
              f"{out['validation_accuracy']:.4f}, confusion "
              f"{out['confusion']}", flush=True)
        _check(out["validation_accuracy"] > 0.8,
               f"train {classifier}: validation accuracy "
               f"{out['validation_accuracy']}")
    out, eval_s = _cli(["evaluate", arc, "--predicted", "pred", "--truth",
                        "labels"], device)
    print(f"[workflows] evaluate: {eval_s:.3f} s, accuracy "
          f"{out['accuracy']:.4f} over {out['points']} points", flush=True)
    _check(out["points"] == len(truth) and out["accuracy"] > 0.8,
           f"evaluate printed {out}")
    archive = CloudArchive.open(arc)
    pred, _, _ = archive.get_asset("pred")
    readers = {".csv": cloud_io.load_ascii,
               ".ply": cloud_io.load_ply,
               ".las": lambda p: cloud_io.load_las(
                   p, with_classification=True)}
    for suffix, read in readers.items():
        path = os.path.join(arc, f"colored{suffix}")
        out, export_s = _cli(["export", arc, "--labels", "pred", "-o", path,
                              "--proba", "pred_proba"], device)
        back = read(path)
        rows, cls = (back[0], back[1]) if suffix == ".las" else (back, None)
        print(f"[workflows] export {suffix}: {export_s:.3f} s, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB, read back "
              f"{rows.shape}", flush=True)
        _check(out == {"written": path} and rows.shape[0] == len(truth),
               f"export {suffix}: {out}, {rows.shape}")
        _check(cls is None or np.array_equal(cls, pred),
               "export .las: classification is not the labels")
    try:
        import matplotlib
    except ImportError:
        print("[workflows] matplotlib: not importable", flush=True)
        return
    print(f"[workflows] matplotlib: {matplotlib.__version__}", flush=True)
    conf = np.asarray(archive.get_asset("pred")[2]["confusion"])
    path = viz.confusion_plot(conf, os.path.join(arc, "confusion.png"))
    _check(os.path.getsize(path) > 0, "confusion_plot wrote nothing")


def _workflow_sweep(out_dir, device):
    """Phase 14's sweep: every row applicable, the fused rows' kernel,
    each row's entry fill its plan's, the best run's trace parsed by
    ``utils.profiling``.  Returns the sweep's packed_moments
    launches."""
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.utils import profiling
    from nimrud_tpu_torch.workflows import sweep

    trace_dir = os.path.join(out_dir, "trace")
    _reset_counts()
    t0 = time.perf_counter()
    ranked = sweep.sweep_extraction(
        n_points=SWEEP_POINTS, methods=("tiled", "fused"),
        tile_factors=(2, 3), capacities=(None,), entry_batches=(256,),
        trace_dir=trace_dir, verbose=False, device=device)
    sweep_s = time.perf_counter() - t0
    counts = _counts()
    _only(counts, ("packed_moments",), "the sweep")
    _check(len(ranked) == 4 and not any("error" in r for r in ranked),
           f"sweep rows {ranked}")
    cloud = sweep.synthetic_scan(SWEEP_POINTS)
    scaleset = [(0.25, (0.5,)), (0.5, (1.0,)), (1.0, (2.0,))]
    for row in ranked:
        tuning = {k: row[k] for k in ("query_tile_factor", "query_capacity",
                                      "entry_batch", "precision")}
        plan = multiscale.plan_report(cloud, cloud, scaleset,
                                      method=row["method"], tuning=tuning,
                                      device=device)
        print(f"[workflows] sweep {row['method']} m {row['query_tile_factor']}"
              f": {row['seconds']} s, {row['point_scales_per_sec']} "
              f"point-scales/s, entry fill {row['entry_fill']}", flush=True)
        _check(row["entry_fill"] == [b["entry_fill"] for b in plan],
               f"sweep row {row}: entry fill differs from plan_report")
    # two fused rows, each run once before its timed repeat(s), and the
    # traced run where a fused row is best
    fused_runs = 2 * 3 + (ranked[0]["method"] == "fused")
    _check(counts["packed_moments"] > 0, "sweep: the fused rows launched no "
           "packed_moments")
    events = profiling.trace_events(trace_dir)
    busy, window = profiling.device_track_stats(events)
    table = profiling.device_op_table(events, top=5)
    print(f"[workflows] sweep of {SWEEP_POINTS} points: {sweep_s:.3f} s, "
          f"{counts['packed_moments']} packed_moments launches in "
          f"{fused_runs} fused runs; best {ranked[0]['method']} m "
          f"{ranked[0]['query_tile_factor']}, its traced run: device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window; top "
          "kernels " + "; ".join(f"{ms} ms x{n} {name[:60]}"
                                 for ms, n, name in table), flush=True)
    _check(0 < busy <= window, f"trace busy {busy} window {window}")
    _check(ranked[0]["method"] != "fused"
           or any("packed" in name for _, _, name in table),
           "the fused run's trace holds no packed_moments kernel")
    return counts["packed_moments"]


def _workflow_phase(device):
    """Phase 14: the archive-to-labels path of the command line at the
    bench's width, in a directory under the gitignored ``_build``, then
    the sweep.  Returns the ``packed_moments`` launches of the
    ``features`` run and of the sweep."""
    import shutil
    import tempfile
    import numpy as np
    from nimrud_tpu_torch.ops.kernels import cuda_build
    from nimrud_tpu_torch.utils import workload

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="workflows-", dir=cuda_build.BUILD_DIR)
    try:
        cloud, labels = workload.make_bench_cloud(N_POINTS, seed=0)
        np.save(os.path.join(work, "cloud.npy"), cloud)
        np.save(os.path.join(work, "labels.npy"), labels)
        arc = os.path.join(work, "arc")
        out, ingest_s = _cli(["ingest", arc, os.path.join(work, "cloud.npy"),
                              "--labels", os.path.join(work, "labels.npy")],
                             device)
        info, _ = _cli(["info", arc], device)
        print(f"[workflows] ingest {ingest_s:.3f} s: {out['points']} points; "
              f"info: assets {sorted(info['assets'])}", flush=True)
        _check(out["points"] == N_POINTS and "labels" in info["assets"],
               f"ingest printed {out}")
        features = _workflow_features(arc, device)
        _workflow_train(arc, labels, device)
        swept = _workflow_sweep(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return features, swept


def _mc_scene(n, seed):
    """The reference pipeline tests' compact scene (a sheet, a vertical
    line and a blob, labels 0 / 1 / 2) at ``n`` points: its tile grids
    are small, so the mesh program runs on the CPU too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    per = n // 3
    cloud = np.vstack([rng.random((per, 3)) * [8, 8, 0.02],
                       rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0],
                       rng.normal([16, 4, 4], 1.0, (n - 2 * per, 3))]
                      ).astype(np.float32)
    labels = np.concatenate([np.zeros(per), np.ones(per),
                             np.full(n - 2 * per, 2)]).astype(np.int32)
    return cloud, labels


def _mc_serve(model, cloud, mesh, attributes=None, shape=MESH_SHAPE):
    """One ``predict_multichip`` to synchronize, counted from zero; any
    overflow warning fails.  Returns (labels, ms, launch counts)."""
    import warnings
    import torch
    _reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        labels = model.predict_multichip(cloud, shape, mesh=mesh,
                                         attributes=attributes)
    torch.cuda.synchronize()
    return labels, 1e3 * (time.perf_counter() - t0), _counts()


def _agree(a, b):
    import numpy as np
    return float((np.asarray(a) == np.asarray(b)).mean())


def _mc_shard_kernel(model, cloud, mesh, device):
    """packed_moments against its twin at one shard's band-0 buckets, as
    the packed mesh program forms them (shard 0 of the (2, 2) mesh: its
    two-phase halo bands, the tile-sorted voxel centers, the shared plan
    at q_cap 256, the segment-wide capacity)."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.ops import device_grid, unique
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    from nimrud_tpu_torch.parallel import mesh as pmesh
    from nimrud_tpu_torch.parallel import tiles

    buffer = max(max(r) for _, r in model.scaleset) \
        + max(e for e, _ in model.scaleset)
    shards = tiles.shard_cloud_2d(cloud, MESH_SHAPE, buffer)
    rows = shards["blocks"].shape[1]
    lo, hi = (np.asarray(b, np.float64) for b in model.bounds)
    caps = model._multichip_caps_cache[(MESH_SHAPE, rows)]
    band = model._shard_band_specs(lo, hi, rows, "packed")[0]
    blocks = pmesh.shards_on(mesh, shards["blocks"], torch.float32)
    valids = pmesh.shards_on(mesh, shards["valid"], torch.bool)
    halo_pts, halo_valid = pmesh._halo_bands_2d(
        blocks, valids, shards["halo_x"], shards["halo_y"], mesh)[0]
    vox, spec, radii = band.vox_spec, band.dev_spec, band.radii
    centers, _, mask = unique.unique_voxels(
        torch.cat([blocks[0], halo_pts]), vox,
        valid=torch.cat([valids[0], halo_valid]), tile_spec=spec)
    plan = device_grid._pack_plan(blocks[0], valids[0], spec)
    spans = device_grid._band_spans(plan, centers, mask, spec,
                                    presorted=True)
    buckets, _ = device_grid._bucket_problems(
        plan["q_t"], plan["centers"], spans["span_starts"],
        spans["span_lens"], device_grid._far_extended(spans["sorted_pts"]),
        caps[0])
    q_t, cand_t, cen = buckets[0][:3]
    shape = (f"E={q_t.shape[0]} q_cap={q_t.shape[2]} c_cap={caps[0]} "
             f"radii={len(radii)}")
    work = pm.packed_moments_work(q_t, cand_t, cen, radii)
    rec = _hold(f"packed_moments shard 0 {shape}",
                lambda p: pm.packed_moments(q_t, cand_t, cen, radii,
                                            precision=p),
                lambda p: pm.packed_moments_plain(q_t, cand_t, cen, radii,
                                                  precision=p),
                lambda ref: pm.moment_tolerance(ref, cand_t, cen))
    live = work["pairs"] / (q_t.shape[0] * caps[0] * q_t.shape[2])
    print(f"[multichip] packed_moments at shard 0's band-0 shapes {shape} "
          f"(live share of lanes {live:.4f}; rows a shard {rows}, halo_x "
          f"{shards['halo_x']}, halo_y {shards['halo_y']}): "
          f"{_work_text(rec, work)}", flush=True)


def _y_face_witness(points, shape, buffer, rows):
    """Whether each of ``rows`` (caller rows of ``points``) lies within
    ``buffer`` of a y face between two blocks of its column of the
    ``shape`` tiling: where the reference's halo plan undersizes the
    y band (ROADMAP Queue C), so a mesh extraction misses neighbors
    across that face."""
    import numpy as np
    from nimrud_tpu_torch.parallel import tiles

    shards = tiles.shard_cloud_2d(points, shape, buffer)
    n_dev, per = shards["valid"].shape
    owner = tiles.unshard(np.repeat(np.arange(n_dev), per).reshape(
        n_dev, per), shards["valid"], shards["order"], len(points))
    my = shape[1]
    faces = {}
    for d in range(n_dev):
        i, j = divmod(d, my)
        ys = shards["blocks"][d][shards["valid"][d], 1]
        if j > 0 and len(ys):
            faces.setdefault(i, []).append(ys.min())
        if j < my - 1 and len(ys):
            faces.setdefault(i, []).append(ys.max())
    near = np.zeros(len(rows), bool)
    for k, r in enumerate(rows):
        col = owner[r] // my
        ys = np.asarray(faces.get(col, []))
        near[k] = bool(len(ys)) and np.abs(ys - points[r, 1]).min() <= buffer
    return near


def _mc_train_extract(mesh, device):
    """``extract_multichip_2d`` at MC_POINTS against a (1, 1) mesh
    (populations equal, and the rest within MC_FEATURE_TOL where both
    radii hold MC_STURDY or more points, except at the rows the y-face
    witness holds: fewer neighbors, within the buffer of a y face),
    then
    ``make_train_step_2d`` for MC_TRAIN_STEPS Adam steps (the loss
    falls; step 0's loss and gradient within rtol 1e-5 of one loss over
    the mesh's own feature rows of all shards -- the mean of the
    per-shard means, as the reference's ``pmean`` -- and beside them
    the (1, 1) program's)."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.parallel import mesh as pmesh
    from nimrud_tpu_torch.parallel import tiles
    from nimrud_tpu_torch.utils import workload

    small, labels = workload.make_bench_cloud(MC_POINTS, seed=0)
    radii = (1.0, 0.5)
    one = pmesh.make_mesh_2d((1, 1), devices=[device])
    t0 = time.perf_counter()
    got = pmesh.extract_multichip_2d(small, radii, mesh_shape=MESH_SHAPE,
                                     mesh=mesh)
    t1 = time.perf_counter()
    want = pmesh.extract_multichip_2d(small, radii, mesh_shape=(1, 1),
                                      mesh=one)
    t2 = time.perf_counter()
    pops = [0, 4]
    off = np.nonzero(np.any(got[:, pops] != want[:, pops], axis=1))[0]
    held = _y_face_witness(small, MESH_SHAPE, max(radii), off) \
        & np.all(got[off][:, pops] <= want[off][:, pops], axis=1)
    # the eigenvalues of small, near-degenerate neighborhoods move with
    # the chunk's frame (two points: rank-1 f32 noise, as the reference
    # tests note); the rest is held where both balls hold MC_STURDY
    rest = np.all(got[:, pops] >= MC_STURDY, axis=1)
    rest[off] = False
    err = float(np.abs(got[rest] - want[rest]).max())
    small_nb = np.all(got[:, pops] >= 3, axis=1)
    small_nb[off] = False
    err3 = float(np.abs(got[small_nb] - want[small_nb]).max())
    print(f"[multichip] extract_multichip_2d at {MC_POINTS} points, radii "
          f"{radii}: (2, 2) {t1 - t0:.3f} s, (1, 1) {t2 - t1:.3f} s; "
          f"populations differ at {len(off)} points, {int(held.sum())} held "
          f"by the y-face witness (fewer neighbors within {max(radii)} m of "
          f"a y face: the reference's halo_y plan); largest difference "
          f"elsewhere where both radii hold {MC_STURDY}+ points {err:.3g}, "
          f"3+ points {err3:.3g} (the chunks' frames differ)", flush=True)
    _check(bool(held.all()), "mesh populations differ from the (1, 1) "
           f"program's without the witness at rows {off[~held][:8]}")
    _check(err <= MC_FEATURE_TOL, "mesh features off the (1, 1) program's")

    gen = torch.Generator(device=device).manual_seed(0)
    init = {"w": torch.randn((4 * len(radii), 3), generator=gen,
                             device=device) / np.sqrt(4 * len(radii)),
            "b": torch.zeros(3, device=device)}
    steps = {}
    for shape, m in ((MESH_SHAPE, mesh), ((1, 1), one)):
        shards = tiles.shard_cloud_2d(small, shape, max(radii),
                                      extras=[labels])
        params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
        opt = torch.optim.Adam(list(params.values()), lr=MC_TRAIN_LR)
        step = pmesh.make_train_step_2d(m, shards["halo_x"], shards["halo_y"],
                                        radii, "minimal", 3, opt)
        losses, grads, times = [], None, []
        for i in range(MC_TRAIN_STEPS if shape == MESH_SHAPE else 1):
            t0 = time.perf_counter()
            losses.append(float(step(params, shards["blocks"],
                                     shards["valid"], shards["extras"][0])))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                grads = {k: p.grad.clone() for k, p in params.items()}
        steps[shape] = (losses, grads, times, shards)
    (losses, grads, times, shards), (l11, g11, t11, _) = \
        steps[MESH_SHAPE], steps[(1, 1)]
    # one loss over all shards' rows of the mesh's own features
    feats = pmesh.sharded_extract_2d(mesh, shards["blocks"], shards["valid"],
                                     shards["halo_x"], shards["halo_y"],
                                     radii, "minimal")
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    labs = torch.as_tensor(shards["extras"][0], device=device).long()
    valid = torch.as_tensor(shards["valid"], device=device).float()
    logits = torch.stack(feats) @ params["w"] + params["b"]
    nll = -torch.log_softmax(logits, dim=2).gather(2, labs[..., None])[..., 0]
    ref = ((nll * valid).sum(1) / valid.sum(1).clamp(min=1.0)).mean()
    ref.backward()
    print(f"[multichip] make_train_step_2d at {MC_POINTS} points, radii "
          f"{radii}, Adam {MC_TRAIN_LR}: losses "
          f"{['%.6f' % v for v in losses]}, step ms "
          f"{['%.1f' % t for t in times]}; step 0 against one loss over the "
          f"mesh's own rows {float(ref.detach()):.6f}; the (1, 1) program's step 0 "
          f"loss {l11[0]:.6f} ({t11[0]:.1f} ms), gradient within "
          + ", ".join(f"{k} {float(((grads[k] - g11[k]).abs() / g11[k].abs().clamp(min=1e-6)).max()):.3g}"
                      for k in grads) + " relative", flush=True)
    _check(losses[-1] < losses[0], f"the mesh loss did not fall {losses}")
    ref = float(ref.detach())
    _check(abs(losses[0] - ref) <= 1e-5 * abs(ref),
           f"step 0 loss {losses[0]} against {ref}")
    for key in grads:
        _check(torch.allclose(grads[key], params[key].grad, rtol=1e-5,
                              atol=1e-7),
               f"step 0 gradient {key} against one loss over the rows")


def _mc_forest(model, cloud, labels, clouds, truths, mesh, device):
    """The rpte model's training rows (a FIT_SAMPLE sample of the packed
    model's features of the bench cloud) fit with ``fit_device`` and with
    ``fit_device_mesh`` over the (2, 2) mesh's four logical shards: the
    tables bit-equal; then that forest served by ``predict_multichip``
    on one cloud.  Returns its launch counts."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.learning.rpt import RPTEnsemble
    from nimrud_tpu_torch.utils import workload

    feats = model.extract_device(cloud)
    rows = np.random.RandomState(0).permutation(len(cloud))[:FIT_SAMPLE]
    x = feats[torch.as_tensor(rows, device=device)]
    y = labels[rows]
    del feats
    t0 = time.perf_counter()
    forest = RPTEnsemble(seed=0).fit_device(x, y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dist = RPTEnsemble(seed=0).fit_device_mesh(
        x.reshape(4, -1, x.shape[1]), np.ones((4, FIT_SAMPLE // 4), bool),
        y.reshape(4, -1), mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = all(torch.equal(dist._tables[k], v)
               for k, v in forest._tables.items())
    print(f"[multichip] fit_device_mesh on {FIT_SAMPLE} training rows over "
          f"4 logical shards ({forest.n_estimators} trees, 3 a shard, 2 pad "
          f"trees): {t2 - t1:.3f} s against fit_device {t1 - t0:.3f} s; "
          f"tables bit-equal {same}", flush=True)
    _check(same, "fit_device_mesh tables differ from fit_device's")
    rpte = workload.make_bench_model(cloud, classifier="rpte", device=device)
    rpte.install_classifier(forest, cloud)
    got, ms, counts = _mc_serve(rpte, clouds[0], mesh)
    acc = _agree(got, truths[0])
    agree = _agree(got, rpte.predict(clouds[0]))
    print(f"[multichip] rpte predict_multichip: {ms:.1f} ms (first call, "
          f"host sizing); launches {counts}; accuracy {acc:.4f}; agreement "
          f"with its single-device labels {agree:.6f}", flush=True)
    _only(counts, ("packed_moments", "forest_walk"), "the rpte mesh program")
    _check(counts["packed_moments"] > 0 and counts["forest_walk"] > 0
           and acc > 0.8 and agree >= 0.99, "rpte mesh serving")
    return counts


def _mc_card_vs_cpu(mesh, device):
    """The packed mesh program on the card and on a CPU mesh, the card
    fit's classifier carried over, on MC_POINTS of the compact scene
    with the bench bands: each differing label a near-tie (top-two gap
    < TIE_GAP) of the card's or the CPU's single-device step."""
    import torch
    from nimrud_tpu_torch.parallel import mesh as pmesh
    from nimrud_tpu_torch.utils import checks, workload

    scene, labels = _mc_scene(MC_POINTS, 0)
    gpu = workload.make_bench_model(scene, device=device)
    gpu.fit(scene, labels, sample=FIT_SAMPLE // 2)
    cpu = workload.make_bench_model(scene, device="cpu")
    cpu.install_classifier(checks.on_cpu(gpu.classifier), scene)
    got, ms, counts = _mc_serve(gpu, scene, mesh)
    t0 = time.perf_counter()
    want = cpu.predict_multichip(
        scene, MESH_SHAPE,
        mesh=pmesh.make_mesh_2d(MESH_SHAPE, devices=[torch.device("cpu")] * 4))
    cpu_s = time.perf_counter() - t0
    differ = torch.from_numpy(got != want)
    g_prob = gpu.predict_staged(gpu.stage(scene), with_proba=True)[1].cpu()
    c_prob = cpu.predict_staged(cpu.stage(scene), with_proba=True)[1]
    gaps = torch.minimum(_top2_gap(g_prob), _top2_gap(c_prob))
    left = differ & (gaps >= TIE_GAP)
    print(f"[multichip] card against cpu, packed mesh program, {MC_POINTS} "
          f"points of the compact scene: card {ms:.1f} ms, cpu {cpu_s:.2f} "
          f"s; {int(differ.sum())} labels differ, "
          f"{int((differ & ~left).sum())} at near-ties; accuracy "
          f"{_agree(got, labels):.4f}; launches {counts}", flush=True)
    _check(not bool(left.any()), "card and cpu mesh labels differ without "
           f"a near-tie at rows {left.nonzero()[:8, 0].tolist()}")
    _check(int(differ.sum()) <= MAX_FLIPS * MC_POINTS,
           "too many card / cpu mesh label flips")
    return scene, labels, counts


def _multichip_phase(model, cloud, labels, clouds, truths, packed_labels,
                     device):
    """Phase 15: the multi-device layer on a (2, 2) mesh of one card's
    four entries.  Returns the launches of its counted runs by kernel
    name."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.parallel import mesh as pmesh
    from nimrud_tpu_torch.parallel import tiles
    from nimrud_tpu_torch.utils import workload

    n_dev = torch.cuda.device_count()
    mesh = pmesh.make_mesh_2d(MESH_SHAPE, devices=[device] * 4)
    default = pmesh.make_mesh_2d((n_dev, 1))
    print(f"[multichip] {_smi('name,power.limit')}; {n_dev} CUDA device(s); "
          f"the {MESH_SHAPE} mesh over {[str(d) for d in mesh.flat]}; the "
          f"default mesh make_mesh_2d(({n_dev}, 1)) over "
          f"{[str(d) for d in default.flat]}", flush=True)
    buffer = max(max(r) for _, r in model.scaleset) \
        + max(e for e, _ in model.scaleset)
    t0 = time.perf_counter()
    shards = tiles.shard_cloud_2d(cloud, MESH_SHAPE, buffer)
    print(f"[multichip] shard_cloud_2d of the {len(cloud)}-point bench "
          f"cloud, buffer {buffer} m: {shards['blocks'].shape[1]} rows a "
          f"shard, halo_x {shards['halo_x']}, halo_y {shards['halo_y']}; "
          f"host {time.perf_counter() - t0:.3f} s", flush=True)
    launches = collections.Counter()

    # the 1M packed bench model at full width, on the three clouds
    torch.cuda.reset_peak_memory_stats()
    served, times, per_step = [], [], []
    for c in clouds:
        got, ms, counts = _mc_serve(model, c, mesh)
        _only(counts, ("packed_moments",), "the packed mesh program")
        served.append(got)
        times.append(ms)
        per_step.append(counts["packed_moments"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches["packed_moments"] += sum(per_step)
    accs = [_agree(s, t) for s, t in zip(served, truths)]
    # the mesh program takes the raw float32 cloud: its single-device
    # twin is the same classifier behind float32 uploads (phase 4's
    # model uploads uint16 grid steps, up to half a step off)
    f32 = workload.make_bench_model(cloud, device=device)
    f32.transfer_dtype = "float32"
    f32.install_classifier(model.classifier, cloud)
    single = [f32.predict(c) for c in clouds]
    agree = [_agree(s, p) for s, p in zip(served, single)]
    agree_u16 = [_agree(s, p.numpy()) for s, p in zip(served, packed_labels)]
    print(f"[multichip] predict_multichip {MESH_SHAPE}, packed bench model: "
          f"step ms {', '.join('%.1f' % t for t in times)} (the first with "
          f"the host sizing of the capacities, then cached); packed_moments "
          f"launches a step {per_step}; overflow 0; accuracy "
          + ", ".join(f"{a:.4f}" for a in accs) + "; agreement with the "
          "single-device labels (float32 uploads) "
          + ", ".join(f"{a:.6f}" for a in agree) + ", (phase 4's uint16 "
          "uploads) " + ", ".join(f"{a:.6f}" for a in agree_u16)
          + f"; peak {peak:.3f} GiB", flush=True)
    _check(all(n > 0 for n in per_step), "packed_moments did not launch")
    _check(all(a > 0.8 for a in accs), f"multichip accuracy {accs}")
    _check(all(a >= MIN_MC_AGREE for a in agree),
           f"multichip agreement with single-device serving {agree}")
    got, ms, counts = _mc_serve(model, clouds[0], None, shape=(n_dev, 1))
    launches["packed_moments"] += counts["packed_moments"]
    print(f"[multichip] the default mesh ({n_dev}, 1): {ms:.1f} ms (host "
          f"sizing of its shard rows), agreement with the single-device "
          f"labels {_agree(got, single[0]):.6f}", flush=True)
    _check(_agree(got, single[0]) >= MIN_MC_AGREE, "default-mesh agreement")
    del f32
    _mc_shard_kernel(model, cloud, mesh, device)

    # the span program (backend="pallas") on one cloud
    span = workload.make_bench_model(cloud, backend="pallas", device=device)
    span.install_classifier(model.classifier, cloud)
    got, ms, counts = _mc_serve(span, clouds[0], mesh)
    launches["span_moments"] += counts["span_moments"]
    print(f"[multichip] span predict_multichip: {ms:.1f} ms; launches "
          f"{counts}; accuracy {_agree(got, truths[0]):.4f}; agreement with "
          f"the packed mesh labels {_agree(got, served[0]):.6f}", flush=True)
    _only(counts, ("span_moments",), "the span mesh program")
    _check(counts["span_moments"] > 0 and _agree(got, truths[0]) > 0.8
           and _agree(got, served[0]) >= MIN_MC_AGREE, "span mesh serving")
    del span
    launches.update(_mc_forest(model, cloud, labels, clouds, truths, mesh,
                               device))

    # vector at MC_POINTS through the segment-wide interp plans
    small, small_labels = workload.make_bench_cloud(MC_POINTS, seed=0)
    attrs = workload.make_bench_attributes(small_labels)
    vec = workload.make_bench_model(small, kind="vector", device=device)
    vec.fit(small, small_labels, sample=MC_POINTS // 2, attributes=attrs)
    got, ms, counts = _mc_serve(vec, small, mesh, attributes=attrs)
    launches.update(counts)
    agree = _agree(got, vec.predict(small, attributes=attrs))
    print(f"[multichip] vector predict_multichip at {MC_POINTS} points: "
          f"{ms:.1f} ms; launches {counts}; accuracy "
          f"{_agree(got, small_labels):.4f}; agreement with its "
          f"single-device labels {agree:.6f}", flush=True)
    _only(counts, KIND_KERNELS["vector"], "the vector mesh program")
    _check(all(counts[k] > 0 for k in KIND_KERNELS["vector"])
           and _agree(got, small_labels) > 0.8 and agree >= 0.99,
           "vector mesh serving")
    del vec

    # card against cpu, then backend="xla" (no moment kernel) on the
    # compact scene
    scene, scene_labels, counts = _mc_card_vs_cpu(mesh, device)
    launches.update(counts)
    xla = workload.make_bench_model(scene, backend="xla", device=device)
    xla.fit(scene, scene_labels, sample=FIT_SAMPLE // 2)
    got, ms, counts = _mc_serve(xla, scene, mesh)
    agree = _agree(got, xla.predict(scene))
    print(f"[multichip] xla predict_multichip at {MC_POINTS} points of the "
          f"compact scene: {ms:.1f} ms; launches {counts}; accuracy "
          f"{_agree(got, scene_labels):.4f}; agreement with its "
          f"single-device labels {agree:.6f}", flush=True)
    _only(counts, (), "the xla mesh program")
    _check(_agree(got, scene_labels) > 0.8 and agree >= 0.99,
           "xla mesh serving")
    del xla
    _mc_train_extract(mesh, device)
    return dict(launches)


def _bench_stage_text(key, rec):
    """One stage of the benchmark's line, as text."""
    trace = rec["trace"]
    text = (f"{key}: predict_staged {rec['predict_ms']['median_ms']:.3f} ms "
            f"median (spread {rec['predict_ms']['spread_ms']:.3f}, "
            f"{rec['predict_ms']['runs']} steps), with stage "
            f"{rec['step_with_stage_ms']['median_ms']:.3f} ms; trace window "
            f"{trace['window_ms_per_step']:.3f} ms a step, busy "
            f"{trace['busy_ms_per_step']:.3f}, idle share "
            f"{trace['idle_share']:.4f}; launches a step "
            f"{rec['launches_per_step']}; peak {rec['peak_gib']:.3f} GiB; "
            f"counters {rec['overflow_counters']}; stage wall "
            f"{rec['stage_wall_s']:.1f} s")
    if "walk_ms" in rec:
        text += f"; the walk alone {rec['walk_ms']:.3f} ms"
    if "roofline" in rec:
        roof = rec["roofline"]
        text += (f"; payload {roof['bytes_total']} B, "
                 f"{roof['achieved_payload_gbps']:.1f} GB/s, "
                 f"{roof.get('pct_of_peak', float('nan')):.2f}% of peak")
    return text


def _group_run(args, timeout, tag, env=None):
    """``python -m <args>`` from the repository root in its own process
    group, killed with its group if it outlives ``timeout``; the last 40
    lines of its stderr printed under ``[tag]``.  Returns (exit code,
    its last stdout line)."""
    import signal
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ if env is None else env,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    for line in err.strip().splitlines()[-40:]:
        print(f"[{tag}] {line}", flush=True)
    line = out.strip().splitlines()[-1] if out.strip() else ""
    print(f"[{tag}] {line}", flush=True)
    return proc.returncode, line


def _bench_phase(started):
    """Phase 16: ``python -m nimrud_tpu_torch.bench`` in its own process
    group under what is left of ``BENCH_BUDGET``; the group is killed if
    it outlives that.  Returns the stages' ``packed_moments`` launches."""
    deadline = BENCH_BUDGET - (time.monotonic() - started) - BENCH_TAIL
    print(f"[bench] deadline {deadline:.0f} s", flush=True)
    rc, line = _group_run(
        ["nimrud_tpu_torch.bench"], deadline + 15, "bench",
        dict(os.environ, NIMRUD_BENCH_DEADLINE_SEC=f"{deadline:.0f}"))
    _check(rc == 0, f"the benchmark exited {rc}")
    result = json.loads(line)
    _check(result["value"] is not None and result["value"] > 0,
           f"the benchmark's value {result['value']}")
    stages = {k: v for k, v in result["detail"].items() if k != "budget"}
    _check(len(stages) == 4, f"the benchmark ran {sorted(stages)}")
    for key, rec in stages.items():
        _check("error" not in rec and "skipped" not in rec,
               f"bench stage {key}: {rec}")
        _check(rec["counters_all_zero"], f"bench stage {key} overflowed: "
               f"{rec['overflow_counters']}")
        # the forest's stage also walks it in the walk kernel
        kernels = {"packed_moments"} | (
            {"forest_walk"} if key == "rpte_serving" else set())
        _check(all(rec["launches_per_step"].get(k, 0) > 0 for k in kernels)
               and set(rec["launches_total"]) == kernels,
               f"bench stage {key} launches {rec['launches_total']}")
        print(f"[bench] {_bench_stage_text(key, rec)}", flush=True)
    print(f"[bench] value {result['value']:.1f} points/s "
          f"({result['vs_baseline']:.1f}x the reference CPU pipeline); "
          f"stage walls {result['detail']['budget']['stage_walls_sec']}",
          flush=True)
    return sum(rec["launches_total"]["packed_moments"]
               for rec in stages.values())


def _backends_text(rec):
    """The backends stage's line, as text."""
    return "backends: " + "; ".join(
        f"{name} {1e3 * sec:.3f} ms an extraction of the three bands "
        f"({rec['point_scales_per_sec_M'][name]:.1f}M point-scales/s), "
        f"launches {rec['launches_per_extract'][name]}, feature sum "
        f"{rec['checks'][name]['feature_sum']:.9g} (relative to "
        f"xla_highest {rec['checks'][name]['rel_vs_xla_highest']:.3g})"
        for name, sec in rec["device_compute_sec_per_extract"].items()) \
        + f"; stage wall {rec['stage_wall_s']:.1f} s"


def _variant_stage(args):
    """One variant stage's process (phase 17), its line checked.
    Returns its line."""
    name = " ".join(args)
    rc, line = _group_run([f"nimrud_tpu_torch.bench.{args[0]}", *args[1:]],
                          VARIANT_TIMEOUT, "variants")
    _check(rc == 0, f"variant stage {name} exited {rc}")
    rec = json.loads(line)
    total = set(rec["launches_total"])
    if args[0] == "backends":
        per = rec["launches_per_extract"]
        _check(per["xla_highest"] == per["xla_mixed"] == {}
               and per["pallas_spans"] == {"span_moments": 3}
               and total == {"span_moments"},
               f"backends launches {per}, in all {rec['launches_total']}")
        rel = rec["checks"]["pallas_spans"]["rel_vs_xla_highest"]
        _check(rel is not None and rel <= SPAN_REL_TOLERANCE,
               f"backends pallas_spans: feature sum {rel} off "
               f"xla_highest's, past {SPAN_REL_TOLERANCE}")
        print(f"[variants] {_backends_text(rec)}", flush=True)
        return rec
    want = {"packed_moments_attr", "packed_moments_interp"} \
        if "vector" in args else {"packed_moments"}
    _check(rec["counters_all_zero"], f"variant stage {name} overflowed: "
           f"{rec['overflow_counters']}")
    _check(rec["train_accuracy"] > 0.8, f"variant stage {name} accuracy "
           f"{rec['train_accuracy']}")
    _check(set(rec["launches_per_step"]) == want and total == want,
           f"variant stage {name} launches {rec['launches_total']}")
    text = _bench_stage_text(name, rec) \
        + f"; accuracy {rec['train_accuracy']:.4f}"
    if "cap_buckets_per_band" in rec:
        text += (f"; site {rec['site_extent_m']} m; capacities a band "
                 f"{rec['cap_buckets_per_band']}; plan occupancy "
                 f"{rec['plan_occupancy']}")
    print(f"[variants] {text}", flush=True)
    return rec


def _density_holds(device):
    """Phase 17's kernel holds: for each regime the bench model fit on
    ``bench.density.make_regime_cloud``, then ``packed_moments`` against
    its twin at the largest-capacity bucket of each band of the serving
    step."""
    import torch
    from nimrud_tpu_torch.bench import density
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    from nimrud_tpu_torch.utils import workload

    for regime in density.REGIMES:
        cloud, labels = density.make_regime_cloud(regime)
        model = workload.make_bench_model(cloud, device=device)
        model.fit(cloud, labels, sample=FIT_SAMPLE)
        for index in range(len(model.scaleset)):
            problems = _served_problems(model, cloud, device, index)
            caps = [cand_t.shape[1] // q_t.shape[0]
                    for _, (q_t, cand_t, _), _ in problems]
            (lo, hi), (q_t, cand_t, cen), rr = problems[
                caps.index(max(caps))]
            del problems
            shape = (f"{regime} band {index} chunk [{lo}, {hi}): "
                     f"E={q_t.shape[0]} q_cap={q_t.shape[2]} c_cap="
                     f"{max(caps)} radii={len(rr)} (capacities {caps})")
            rec = _hold(
                f"packed_moments density {shape}",
                lambda p: pm.packed_moments(q_t, cand_t, cen, rr,
                                            precision=p),
                lambda p: pm.packed_moments_plain(q_t, cand_t, cen, rr,
                                                  precision=p),
                lambda ref: pm.moment_tolerance(ref, cand_t, cen))
            work = pm.packed_moments_work(q_t, cand_t, cen, rr)
            live = work["pairs"] / (q_t.shape[0] * max(caps) * q_t.shape[2])
            print(f"[kernel] packed_moments density {shape} (live share of "
                  f"lanes {live:.3f}): {_work_text(rec, work)}", flush=True)
            del q_t, cand_t, cen
        del model
        torch.cuda.empty_cache()


def _backends_holds(device, xla_sum):
    """Phase 17's span holds: the backends stage's cloud and bands, built
    here as the stage builds them, and ``span_moments`` against its twin
    at each band's span problem as ``fused_extract_spans`` forms it.  Then
    the three bands' feature sum from the kernel's slabs and from a bf16
    control (the same slabs rounded to bf16), each relative to the
    stage's ``xla_highest`` sum ``xla_sum``: the kernel's must lie within
    ``SPAN_REL_TOLERANCE`` and the control's past it."""
    import numpy as np
    import torch
    from nimrud_tpu_torch.bench import backends
    from nimrud_tpu_torch.ops import device_grid
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk

    cloud = backends.make_cloud(backends.N_POINTS, np.random.default_rng(0))
    n = len(cloud)
    query = torch.from_numpy(cloud).to(device)
    q_valid = torch.ones(n, dtype=torch.bool, device=device)
    sums = {"kernel": 0.0, "bf16 control": 0.0}
    for edge, (centers, mask, spec, radii) in zip(
            backends.EDGES, backends.make_bands(cloud, query)):
        prob = device_grid._span_problem(query, q_valid, centers, mask, spec)
        args = device_grid.span_args(prob)
        rows = prob["span_rows"]
        _span_hold(f"backends band edge {edge} radius {radii[0]}", args,
                   radii, rows)
        slabs = gk.span_moments(*args, radii, rows)
        for name, got in (("kernel", slabs),
                          ("bf16 control", slabs.to(torch.bfloat16).float())):
            feats = device_grid.span_features(got, prob, spec, radii,
                                              "minimal", n, n)
            sums[name] += float(feats.sum(dtype=torch.float64))
        del prob, args, slabs, feats
    rel = {k: abs(v - xla_sum) / abs(xla_sum) for k, v in sums.items()}
    print(f"[variants] backends: the three bands' feature sum relative to "
          f"xla_highest's ({xla_sum:.9g}): " + ", ".join(
              f"{k} {sums[k]:.9g} ({v:.3g})" for k, v in rel.items())
          + f"; tolerance {SPAN_REL_TOLERANCE}", flush=True)
    _check(rel["kernel"] <= SPAN_REL_TOLERANCE,
           f"backends: the span kernel's feature sum {rel['kernel']} off "
           f"xla_highest's, past {SPAN_REL_TOLERANCE}")
    _check(rel["bf16 control"] > SPAN_REL_TOLERANCE,
           f"backends: the bf16 control's feature sum {rel['bf16 control']}"
           f" lies within {SPAN_REL_TOLERANCE}")


def _variants_phase(device):
    """Phase 17: the five variant stages, each in its own process, then
    the span holds at the backends stage's bands and the density holds.
    Returns the stages' launches by kernel name."""
    import torch
    torch.cuda.empty_cache()           # the stages' processes allocate
    launches = collections.Counter()
    recs = {}
    for args in VARIANT_STAGES:
        recs[args] = _variant_stage(args)
        launches.update(recs[args]["launches_total"])
    _backends_holds(device, recs[("backends",)]["checks"]["xla_highest"]
                    ["feature_sum"])
    _density_holds(device)
    return dict(launches)


def _fuzz_config(rng):
    """One random draw of the reference's equivalence test (a copy of
    ``_random_config`` in tests/test_fuzz_equivalence.py, which this
    script cannot import: no jax here): (n_search, n_query, aspect, edge,
    radii, kind, m, q_cap)."""
    n_search = int(rng.integers(1500, 6000))
    n_query = int(rng.integers(200, 800))
    aspect = rng.choice([
        [10, 10, 10], [30, 30, 2], [40, 4, 4], [15, 15, 0.5]])
    edge = float(rng.choice([0.2, 0.35, 0.5]))
    n_radii = int(rng.integers(1, 3))
    top = float(rng.choice([0.8, 1.2, 1.6]))
    radii = tuple(round(top / (2 ** i), 3) for i in range(n_radii))
    kind = str(rng.choice(["minimal", "geometric", "covariance"]))
    m = int(rng.choice([2, 3]))
    q_cap = int(rng.choice([16, 64]))
    return n_search, n_query, aspect, edge, radii, kind, m, q_cap


def _fuzz_scene(case):
    """Draw ``case``'s scene as the reference's test builds it
    (``default_rng(1000 + case)``): half uniform, half five blobs,
    clipped to the aspect box; the queries a permutation of the search
    cloud.  Returns a dict: ``query``, ``search`` (float32), ``edge``,
    ``radii``, ``kind``, ``m``, ``q_cap``, ``aspect``."""
    import numpy as np
    rng = np.random.default_rng(1000 + case)
    n_search, n_query, aspect, edge, radii, kind, m, q_cap = \
        _fuzz_config(rng)
    uniform = rng.random((n_search // 2, 3)) * aspect
    blob_centers = rng.random((5, 3)) * aspect
    blobs = (blob_centers[rng.integers(0, 5, n_search - len(uniform))]
             + rng.normal(0, min(aspect) / 8 + 0.05,
                          (n_search - len(uniform), 3)))
    search = np.clip(np.vstack([uniform, blobs]), 0,
                     aspect).astype(np.float32)
    query = search[rng.permutation(n_search)[:n_query]]
    return {"query": query, "search": search, "edge": edge, "radii": radii,
            "kind": kind, "m": m, "q_cap": q_cap, "aspect": aspect}


def _fuzz_route(name, scene, device):
    """One of ``FUZZ_ROUTES`` on a draw's scene on ``device``: the
    (n_query, width) float32 features as a NumPy array.  ``tiled_entry``
    builds the tiled problem over the band's voxel centers with the
    draw's m and q_cap and sums on the entry kernel."""
    from nimrud_tpu_torch.features import multiscale
    from nimrud_tpu_torch.ops import grid

    query, search = scene["query"], scene["search"]
    radii, kind = scene["radii"], scene["kind"]
    tuning = {"query_tile_factor": scene["m"],
              "query_capacity": scene["q_cap"]}
    if name == "tiled_entry":
        centers, _ = multiscale.voxel_downsample(search, scene["edge"],
                                                 device=device)
        problem = grid.build_tiled_problem(
            query, centers, max(radii), query_tile_factor=scene["m"],
            query_capacity=scene["q_cap"], entry_batch=TILED_BATCH)
        return grid.tiled_features(
            problem, query, centers, radii, kind, entry_batch=TILED_BATCH,
            backend="pallas", device=device).cpu().numpy()
    method, _, backend = name.partition("_")
    if backend:
        tuning["backend"] = FUZZ_BACKENDS[backend]
    return multiscale.extract_scaleset(
        query, search, [(scene["edge"], radii)], kind=kind, method=method,
        tuning=None if method == "dense" else tuning, device=device)


def _fuzz_agree(got, ref, n_radii, pop_tol):
    """The reference test's bars between two routes' features: per
    radius the population column (the first of each block) equal within
    rtol 1e-6 on at least ``1 - pop_tol`` of the queries, and where it
    is, more than ``FUZZ_CLOSE`` of the block within ``FUZZ_RTOL`` /
    ``FUZZ_ATOL``.  Returns (ok, the least population share, the least
    close share)."""
    import numpy as np
    width = ref.shape[1] // n_radii
    pops, closes = [], []
    for ri in range(n_radii):
        agree = np.isclose(ref[:, width * ri], got[:, width * ri], rtol=1e-6)
        cols = slice(width * ri, width * (ri + 1))
        pops.append(float(agree.mean()))
        closes.append(float(np.isclose(got[agree, cols], ref[agree, cols],
                                       rtol=FUZZ_RTOL,
                                       atol=FUZZ_ATOL).mean()))
    ok = (got.shape == ref.shape and min(pops) >= 1.0 - pop_tol - 1e-9
          and min(closes) > FUZZ_CLOSE)
    return ok, min(pops), min(closes)


def _fuzz_card_vs_cpu(what, card, cpu, scene, centers):
    """One route's card features against its CPU run (the plain twins):
    per radius the population column equal but at the rows the float64
    oracle witnesses (a voxel center within ``_d2_tolerance`` of r*r,
    the global extent bounding every frame), every feature of the other
    rows within ``FUZZ_RTOL`` / ``FUZZ_ATOL``.  Returns (rows whose
    population differs, the largest feature error as a share of its
    bar)."""
    import numpy as np
    import torch
    _check(card.shape == cpu.shape and np.isfinite(card).all(),
           f"{what}: card features {card.shape}, CPU {cpu.shape}, or "
           "non-finite")
    radii = scene["radii"]
    width = cpu.shape[1] // len(radii)
    extent = float(max(np.abs(scene["query"]).max(), np.abs(centers).max()))
    differ, worst = 0, 0.0
    for ri, radius in enumerate(radii):
        agree = np.isclose(card[:, width * ri], cpu[:, width * ri],
                           rtol=1e-6)
        rows = np.nonzero(~agree)[0]
        if len(rows):
            _, near, _, _, _ = _float64_oracle(
                torch.from_numpy(scene["query"][rows]),
                torch.from_numpy(centers), radius,
                _d2_tolerance(radius, extent))
            _check(bool((near > 0).all()),
                   f"{what} radius {radius}: {int((near == 0).sum())} of "
                   f"{len(rows)} rows differ in population with no voxel "
                   "center at the rounding bound of r*r")
        differ += len(rows)
        cols = slice(width * ri, width * (ri + 1))
        a, b = card[agree, cols], cpu[agree, cols]
        share = np.abs(a - b) / (FUZZ_ATOL + FUZZ_RTOL * np.abs(b))
        worst = max(worst, float(share.max()) if share.size else 0.0)
    _check(worst <= 1.0, f"{what}: a feature {worst:.3g}x its bar off the "
           "CPU's")
    return differ, worst


@contextlib.contextmanager
def _fuzz_capture(calls):
    """Within the block, each moment kernel's wrapper records its call
    (kernel name, args, kwargs) in ``calls`` and returns its plain
    twin's slabs: no kernel launches, no count moves."""
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    patched = ((pm, "packed_moments", pm.packed_moments_plain),
               (gk, "span_moments", gk.span_moments_plain),
               (mk, "entry_moments", mk.entry_moments_plain))

    def recorder(name, plain):
        def record(*args, **kwargs):
            calls.append((name, args, kwargs))
            return plain(*args, **kwargs)
        return record

    kernels = [getattr(module, name) for module, name, _ in patched]
    for module, name, plain in patched:
        setattr(module, name, recorder(name, plain))
    try:
        yield
    finally:
        for (module, name, _), kernel in zip(patched, kernels):
            setattr(module, name, kernel)


def _fuzz_call_shape(name, args):
    """(q_cap, text, pairs) of one captured kernel call."""
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm
    if name == "packed_moments":
        q_t, cand_t, cen, radii = args[:4]
        pairs = pm.packed_moments_work(q_t, cand_t, cen, radii)["pairs"]
        return q_t.shape[2], (f"E={q_t.shape[0]} q_cap={q_t.shape[2]} "
                              f"c_cap={cand_t.shape[1] // q_t.shape[0]} "
                              f"radii={len(radii)}"), pairs
    if name == "span_moments":
        pairs = gk.span_moments_work(*args[:7])["pairs"]
        return args[0].shape[1], (f"E={args[0].shape[0]} q_cap="
                                  f"{args[0].shape[1]} spans="
                                  f"{args[2].shape[1]} span_rows={args[6]} "
                                  f"radii={len(args[5])}"), pairs
    pairs = mk.entry_moments_work(*args[:4])["pairs"]
    return args[0].shape[1], (f"E={args[0].shape[0]} q_cap="
                              f"{args[0].shape[1]} F={args[1].shape[1]} "
                              f"radii={len(args[3])}"), pairs


def _fuzz_picks(calls):
    """The captured calls a kernel is held at: for each kernel and q_cap
    the smallest and the largest by pairs, and the largest of a draw with
    m = 2 and two radii.  ``calls``: (case, scene, name, args, kwargs).
    Returns {(kernel, q_cap): [indices into ``calls``]}."""
    groups = collections.defaultdict(list)
    for i, (_, scene, name, args, _) in enumerate(calls):
        q_cap, _, pairs = _fuzz_call_shape(name, args)
        two = scene["m"] == 2 and len(scene["radii"]) == 2
        groups[(name, q_cap)].append((pairs, i, two))
    picks = {}
    for key, group in groups.items():
        group.sort()
        chosen = {group[0][1], group[-1][1]}
        chosen.update([i for _, i, two in group if two][-1:])
        picks[key] = sorted(chosen)
    return picks


def _fuzz_hold(case, name, args, kwargs):
    """One captured kernel call held against its plain twin on the card
    (``_hold``: both precisions where the kernel reads one); prints the
    kernel line.  Returns (the numbers of ``_hold``, the work)."""
    from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
    from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
    from nimrud_tpu_torch.ops.kernels import packed_moments as pm

    _, shape, _ = _fuzz_call_shape(name, args)
    what = f"{name} fuzz draw {case} {shape}"
    if name == "span_moments":
        return _span_hold(f"fuzz draw {case} radii={len(args[5])}",
                          args[:5], args[5], args[6])
    if name == "packed_moments":
        kw = {k: v for k, v in kwargs.items() if k != "precision"}
        rec = _hold(what,
                    lambda p: pm.packed_moments(*args, precision=p, **kw),
                    lambda p: pm.packed_moments_plain(*args, precision=p,
                                                      **kw),
                    lambda ref: pm.moment_tolerance(ref, args[1], args[2]))
        work = pm.packed_moments_work(*args[:4])
    else:
        rec = _hold(what, lambda _: mk.entry_moments(*args, **kwargs),
                    lambda _: mk.entry_moments_plain(*args, **kwargs),
                    lambda ref: mk.entry_tolerance(ref, args[1], args[2]),
                    precisions=("highest",))
        work = mk.entry_moments_work(*args[:4])
    print(f"[kernel] {what}: {_work_text(rec, work)}", flush=True)
    return rec, work


def _fuzz_draw(case, device, calls):
    """Phase 18 on one draw: the six routes on the card, each counted
    from zero; ``dense`` and the kernel routes against their CPU runs;
    every route against the card's ``dense`` with the reference test's
    bars; the kernel routes run once more with their kernels' calls
    captured into ``calls``.  Returns the launches by kernel name."""
    from nimrud_tpu_torch.features import multiscale

    scene = _fuzz_scene(case)
    centers, _ = multiscale.voxel_downsample(scene["search"], scene["edge"],
                                             device="cpu")
    card, launches, held = {}, collections.Counter(), {}
    for name, kernel in FUZZ_ROUTES.items():
        _reset_counts()
        card[name] = _fuzz_route(name, scene, device)
        counts = _counts()
        _only(counts, (kernel,), f"fuzz draw {case} {name}")
        _check(kernel is None or counts[kernel] > 0,
               f"fuzz draw {case} {name} launched no {kernel}")
        if kernel is not None:
            launches[kernel] += counts[kernel]
            captured = []
            with _fuzz_capture(captured):
                _fuzz_route(name, scene, device)
            calls += [(case, scene, k, a, kw) for k, a, kw in captured]
        if kernel is not None or name == "dense":
            held[name] = _fuzz_card_vs_cpu(
                f"fuzz draw {case} {name}", card[name],
                _fuzz_route(name, scene, "cpu"), scene, centers)
    agree = {}
    for name, tol in FUZZ_POP_TOL.items():
        ok, pop, close = _fuzz_agree(card[name], card["dense"],
                                     len(scene["radii"]), tol)
        _check(ok, f"fuzz draw {case} {name} against dense: populations "
               f"{pop}, close {close}")
        agree[name] = pop
    print(f"[fuzz] draw {case}: config {len(scene['search'])} search, "
          f"{len(scene['query'])} query points, aspect "
          f"{scene['aspect'].tolist()}, edge {scene['edge']}, radii "
          f"{scene['radii']}, {scene['kind']}, m {scene['m']}, q_cap "
          f"{scene['q_cap']}; routes {', '.join(FUZZ_ROUTES)}; launches "
          f"{dict(launches)}; populations equal on "
          + ", ".join(f"{k} {v:.4f}" for k, v in agree.items())
          + " of dense's; card against CPU (rows witnessed, largest "
          "feature error as a share of its bar) " + ", ".join(
              f"{k} {n} / {v:.3g}" for k, (n, v) in held.items()),
          flush=True)
    return launches


def _fuzz_examples():
    """Phase 18's examples: ``python -m nimrud_tpu_torch.examples.<name>``
    at their default sizes on the card, each in its own process group;
    exit 0 and the accuracy of the last line > 0.8."""
    import re
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nimrud_tpu_torch", "_build", "examples")
    for example in ("serving", "training"):
        workdir = os.path.join(root, example)
        os.makedirs(workdir, exist_ok=True)
        t0 = time.perf_counter()
        rc, line = _group_run([f"nimrud_tpu_torch.examples.{example}",
                               "--workdir", workdir], VARIANT_TIMEOUT,
                              "fuzz")
        found = re.search(r"accuracy ([0-9.]+)", line)
        _check(rc == 0 and found and float(found.group(1)) > 0.8,
               f"example {example} exited {rc}: {line}")
        print(f"[fuzz] example {example}: exit 0, accuracy "
              f"{found.group(1)}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    shutil.rmtree(root)


def _fuzz_phase(device):
    """Phase 18: the reference's random draws through the six routes on
    the card, the kernels held at the drawn shapes, the two examples.
    Returns the draws' launches by kernel name."""
    launches, calls = collections.Counter(), []
    for case in range(FUZZ_DRAWS):
        launches.update(_fuzz_draw(case, device, calls))
    for (name, q_cap), picks in sorted(_fuzz_picks(calls).items()):
        for i in picks:
            case, _, _, args, kwargs = calls[i]
            _fuzz_hold(case, name, args, kwargs)
    del calls
    _fuzz_examples()
    return dict(launches)


def _build_phase(cuda_build):
    """Build every kernel, all nvcc processes together; print ptxas's
    usage and the tensor-core instructions of each template instance.
    No kernel may spill, each has its number of instances, and every
    instance of a moment kernel must hold HMMA instructions."""
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for kernel, (path, report) in built.items():
        hmma = cuda_build.count_sass(cuda_build.sass(path))
        print(f"[build] {kernel} ptxas: "
              + " | ".join(cuda_build.ptxas_usage(report)), flush=True)
        print(f"[build] {kernel} HMMA instructions (cuobjdump -sass): "
              + ", ".join(f"{k} {v}" for k, v in hmma.items()), flush=True)
        _check(cuda_build.spill_bytes(report) == 0, f"{kernel} spills")
        _check(len(hmma) == INSTANCES[kernel], f"{kernel}: instances {hmma}")
        _check(kernel not in MMA_KERNELS or min(hmma.values()) > 0,
               f"{kernel}: a template instance without HMMA {hmma}")


def _smi(query):
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile three serving steps of each "
                             "backend and of the vector layout, and three "
                             "tiled runs of band 0; write the traces and "
                             "kernel tables to DIR")
    args = parser.parse_args()
    started = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nimrud_tpu_torch.ops.kernels import cuda_build
    from nimrud_tpu_torch.utils import workload

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(_smi("name,power.limit"))
    print(f"[card] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)
    _build_phase(cuda_build)

    cloud, labels = workload.make_bench_cloud(N_POINTS, seed=0)
    model = workload.make_bench_model(cloud, device=device)
    served = [workload.make_bench_cloud(N_POINTS, seed=s) for s in (0, 1, 2)]
    clouds = [c for c, _ in served]
    truths = [t for _, t in served]
    _native_phase(model, cloud, clouds, device)
    record = dict(zip(("packed_moments", "packed_moments_sazo"),
                      _packed_kernel_phase(model, cloud, device)))
    print("[kernel] SM clock, max SM clock: "
          + _smi("clocks.sm,clocks.max.sm"), flush=True)

    # -- the packed path, counted from zero ----------------------------------
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    model.fit(cloud, labels, sample=FIT_SAMPLE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = _counts()
    fit_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps, packed_labels, _, diags = _serve(model, clouds)
    counts = _counts()
    serve_launches = counts["packed_moments"] \
        - fit_counts["packed_moments"]
    step_peak = torch.cuda.max_memory_allocated()
    accs = _check_served("packed", diags, packed_labels, truths)
    print(f"[main] fit {fit_s:.3f} s ({fit_counts['packed_moments']} "
          f"kernel launches); serve steps ms (total, stage, predict+sync): "
          f"{_steps_text(steps)}; {serve_launches} serve launches "
          f"({serve_launches / len(clouds):g} a step); "
          "accuracy " + ", ".join(f"{a:.4f}" for a in accs)
          + f"; counters {diags}; launches {counts}; peak fit "
          f"{fit_peak / 2**30:.3f} GiB, serving {step_peak / 2**30:.3f} GiB",
          flush=True)
    _check(fit_counts["packed_moments"] > 0, "the kernel did not run in fit")
    _check(serve_launches > 0, "the kernel did not run in serving")
    _only(counts, ("packed_moments",), "the packed path")
    launches = {"packed_moments": counts["packed_moments"]}
    if args.profile:
        _serving_profile(model, args.profile)
    designated_step = _designated_phase(model, cloud, labels, device,
                                        args.profile)

    launches["span_moments"], record["span_moments"] = _span_phase(
        model, packed_labels, clouds, truths, cloud, device, args.profile)
    launches["entry_moments"], record["entry_moments"], band0 = \
        _tiled_phase(model, cloud, device, args.profile)
    print(f"[launches] packed_moments: fit {fit_counts['packed_moments']}, "
          f"serving {serve_launches / len(clouds):g} a step, designated "
          f"serving {designated_step:g} a step; span_moments "
          f"{launches['span_moments'] / len(clouds):g} a step; entry_moments "
          f"{launches['entry_moments']} a tiled run ({len(model.scaleset)} "
          "bands)", flush=True)
    _xla_phase(model, packed_labels, clouds, truths, cloud, labels, band0,
               device, args.profile)
    kind_launches, per_kind, vector = _kinds_phase(cloud, labels, clouds,
                                                   truths, device,
                                                   args.profile)
    launches.update(kind_launches)
    for family, n in kind_launches.items():
        kind = next(k for k, v in KIND_KERNELS.items() if family in v)
        print(f"[launches] {family}: {n} in the {kind} fit and its "
              f"{KINDS[kind]} serving steps ({per_kind[family][0]} in the "
              f"fit, {per_kind[family][1]:g} a serving step)", flush=True)
    record.update(_vector_kernel_phase(
        vector, cloud, workload.make_bench_attributes(labels), device,
        per_kind))
    del vector
    _e2e_phase(device)
    excl_launches, excl_records = _exclusion_phase(cloud, labels, clouds,
                                                   truths, band0, device)
    launches.update(excl_launches)
    record.update(excl_records)
    walled = {}
    for phase, run in (
            ("rpte", lambda: _rpte_phase(cloud, labels, clouds, truths,
                                         device, args.profile)),
            ("large", lambda: _large_phase(device)),
            ("knn", lambda: _knn_phase(device)),
            ("host", lambda: _host_phase(
                cloud, labels, clouds, truths, device,
                [("1M packed fit", N_POINTS, fit_peak),
                 ("1M packed serving steps", N_POINTS, step_peak),
                 ("10M chunked steps", N_LARGE, walled["large"][0]),
                 ("10M un-chunked step", N_LARGE, walled["large"][1])])),
            ("workflows", lambda: _workflow_phase(device)),
            ("multichip", lambda: _multichip_phase(
                model, cloud, labels, clouds, truths, packed_labels,
                device))):
        t0 = time.perf_counter()
        walled[phase] = run()
        print(f"[{phase}] phase wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    del model
    record["forest_walk"] = walled["rpte"]
    launches["forest_walk"] = walled["rpte"][0]["launches"]
    features, swept = walled["workflows"]
    launches["packed_moments"] += features + swept
    print(f"[launches] packed_moments: {features} in the features workflow, "
          f"{swept} in the sweep", flush=True)
    for kernel, n in walled["multichip"].items():
        if n:
            launches[kernel] = launches.get(kernel, 0) + n
    print(f"[launches] the multichip phase: "
          f"{ {k: n for k, n in walled['multichip'].items() if n} }",
          flush=True)
    t0 = time.perf_counter()
    fuzzed = _fuzz_phase(device)
    for kernel, n in fuzzed.items():
        launches[kernel] = launches.get(kernel, 0) + n
    print(f"[fuzz] phase wall {time.perf_counter() - t0:.1f} s; launches "
          f"in the twelve draws {fuzzed}", flush=True)
    t0 = time.perf_counter()
    varied = _variants_phase(device)
    for kernel, n in varied.items():
        launches[kernel] = launches.get(kernel, 0) + n
    print(f"[variants] phase wall {time.perf_counter() - t0:.1f} s; "
          f"launches in the five stages {varied}", flush=True)
    torch.cuda.empty_cache()           # the benchmark's processes allocate
    t0 = time.perf_counter()
    benched = _bench_phase(started)
    launches["packed_moments"] += benched
    print(f"[bench] phase wall {time.perf_counter() - t0:.1f} s; "
          f"packed_moments: {benched} in the benchmark's four stages; the "
          f"script {time.monotonic() - started:.1f} s", flush=True)

    sources = {
        "packed_moments": ("packed_moments",
                           "nimrud_tpu/ops/pallas/packed_kernel.py:236"),
        "packed_moments_sazo": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (with_sazo)"),
        "packed_moments_attr": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (n_attr)"),
        "packed_moments_interp": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (chebyshev, n_attr)"),
        "packed_moments_excl": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (exclude_radius)"),
        "packed_moments_excl_sazo": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (exclude_radius, "
            "with_sazo)"),
        "packed_moments_excl_attr": (
            "packed_moments",
            "nimrud_tpu/ops/pallas/packed_kernel.py:236 (exclude_radius, "
            "n_attr)"),
        "span_moments": ("span_moments",
                         "nimrud_tpu/ops/pallas/gather_kernel.py:330"),
        "span_moments_excl": (
            "span_moments",
            "nimrud_tpu/ops/pallas/gather_kernel.py:330 (exclude_radius)"),
        "entry_moments": ("entry_moments",
                          "nimrud_tpu/ops/pallas/multiscale_kernel.py:84"),
        "entry_moments_excl": (
            "entry_moments",
            "nimrud_tpu/ops/pallas/multiscale_kernel.py:84 "
            "(exclude_radius)"),
        "forest_walk": (
            "forest_walk",
            "none: the JAX package walks the forest in XLA "
            "(nimrud_tpu/learning/rpt.py _walk_forest_dense)")}
    # no single PyTorch call computes a masked moment sum or a forest
    # walk: library_ms null
    print(json.dumps({"kernels": [{
        "name": kernel, "route": "cuda",
        "source": f"nimrud_tpu_torch/csrc/{source}.cu",
        "replaces": replaces, "launches": launches[kernel],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "pairs": work["pairs"],
        "bound_ms": work["bound_ms"],
        "bound_by": "bytes" if work["bound_term"] == "bytes" else "operations",
        "library_ms": None}
        for kernel, (source, replaces) in sources.items()
        for rec, work in [record[kernel]]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
