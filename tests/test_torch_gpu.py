"""
Tests that need a CUDA card (marker ``gpu``): the hand-written Hopper
kernels (``packed_moments`` and its sazo, attribute and chebyshev
instances, ``span_moments``, ``entry_moments``, and the
``exclude_radius`` instances of all three) against their plain PyTorch
twins on the card, and small serving runs of both backends (and of the
``vector`` layout and an ``exclude_radius`` model) on the card against
the same model on the CPU; designated-search serving (a staged search
map, the stream's side stream) and staging on the C++ host runtime
against its NumPy twin; entry-chunked serving against the un-chunked
step, the random-projection-tree forest (its device fit, its walks
and its serving step), the XLA tile path, the dense method and an
``xla`` model's serving step on the card against the CPU; the kNN and radius neighbor search
(ties on a 1/8 m grid, a candidate at exactly ``f32(r*r)``) and the kNN
features on the card against the CPU, the host-classifier route
(a NumPy classifier, no sklearn) on the card, and the multi-device
layer on a (2, 2) mesh of one card's four entries against a CPU mesh
(``predict_multichip`` on the packed and span backends, the 2-D sharded
extraction, the forest's mesh fit bit-equal to its single-device fit),
the benchmark's headline stage at 100k points, and its urban density
stage at 100k points.
They skip without a card.  On a machine with one:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

(``tests/conftest.py`` imports jax; ``--noconftest`` lets these tests run
where jax is not installed.)
"""

import json

import numpy as np
import pytest
import torch

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.learning.rpt import RPTEnsemble
from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
from nimrud_tpu_torch.ops.kernels import packed_moments as pm
from nimrud_tpu_torch.utils import checks, workload
from torch_entry_cases import entry_problem, with_nan
from torch_rpt_cases import forest_data
import torch_exclude_cases as excl

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(n_entries, q_cap, c_cap, seed, scattered=False):
    """Candidates about each entry center; dead lanes (FAR) fill the last
    quarter of each block or, ``scattered``, a random 60% of the lanes
    and every lane of a few entries."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_entries, 3)) * 50).astype(np.float32)
    q_t = (centers[:, :, None]
           + rng.uniform(-2, 2, (n_entries, 3, q_cap))).astype(np.float32)
    cand = (centers.T[:, :, None]
            + rng.uniform(-3, 3, (3, n_entries, c_cap))).astype(np.float32)
    if scattered:
        dead = rng.random((n_entries, c_cap)) < 0.6
        dead[::9] = True
        cand[:, dead] = pm.FAR
    else:
        cand[:, :, c_cap * 3 // 4:] = pm.FAR
    return q_t, np.ascontiguousarray(cand.reshape(3, -1)), centers


@pytest.mark.parametrize("q_cap,c_cap,radii,precision,scattered", [
    (512, 1024, (1.0,), "highest", False),
    (256, 384, (0.5, 2.0), "highest", False),
    (16, 128, (0.5,), "highest", False),
    (130, 256, (0.5, 1.0, 1.5, 2.0), "highest", False),
    (130, 256, (0.5, 1.0, 1.5, 2.0), "bf16x2", True),
    (256, 768, (1.0,), "bf16x2", True)])
def test_kernel_matches_plain_on_card(cuda, q_cap, c_cap, radii, precision,
                                      scattered):
    q_t, cand_t, centers = (torch.from_numpy(a).to(cuda) for a in
                            _problem(37, q_cap, c_cap, seed=q_cap,
                                     scattered=scattered))
    before = pm.packed_moments.launches
    got = pm.packed_moments(q_t, cand_t, centers, radii, precision=precision)
    torch.cuda.synchronize()
    assert pm.packed_moments.launches == before + 1
    ref = pm.packed_moments_plain(q_t, cand_t, centers, radii,
                                  precision=precision)
    counts = slice(0, None, 16)
    assert torch.equal(got[..., counts], ref[..., counts])
    assert ref[..., counts].max() > 0
    tol = pm.moment_tolerance(ref, cand_t, centers)
    assert bool(((got - ref).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())


def _sazo_case(cuda, q_t, cand_t, centers, radii, precision="highest"):
    """The sazo instance on the card against the twin: one launch, counts
    equal, moments within tolerance, rows 10 / 11 bit for bit, and every
    other row bit for bit the kernel's without the fold.  Returns the
    kernel slabs."""
    args = [torch.from_numpy(a).to(cuda) for a in (q_t, cand_t, centers)]
    before = (pm.packed_moments.launches, pm.packed_moments.sazo_launches)
    got = pm.packed_moments(*args, radii, precision=precision,
                            with_sazo=True)
    torch.cuda.synchronize()
    assert (pm.packed_moments.launches,
            pm.packed_moments.sazo_launches) == (before[0], before[1] + 1)
    ref = pm.packed_moments_plain(*args, radii, precision=precision,
                                  with_sazo=True)
    assert torch.equal(got[..., 0::16], ref[..., 0::16])
    for row in (10, 11):
        assert torch.equal(got[..., row::16], ref[..., row::16])
    tol = pm.moment_tolerance(ref, args[1], args[2])
    assert bool(((got - ref).abs() <= tol).all())
    plain = pm.packed_moments(*args, radii, precision=precision)
    keep = torch.ones(got.shape[-1], dtype=torch.bool, device=cuda)
    keep[10::16] = keep[11::16] = False
    assert torch.equal(got[..., keep], plain[..., keep])
    return got


@pytest.mark.parametrize("q_cap,c_cap,radii,precision", [
    (512, 1024, (1.0,), "highest"), (256, 384, (0.5, 2.0), "highest"),
    (130, 256, (0.5, 1.0, 1.5), "bf16x2"),
    (130, 256, (0.5, 1.0, 1.5, 2.0), "highest"),
    (16, 128, (0.5,), "bf16x2")])
def test_sazo_kernel_matches_plain_on_card(cuda, q_cap, c_cap, radii,
                                           precision):
    # scattered FAR lanes, every ninth entry all FAR (empty entries)
    q_t, cand_t, centers = _problem(37, q_cap, c_cap, seed=q_cap + 1,
                                    scattered=True)
    got = _sazo_case(cuda, q_t, cand_t, centers, radii, precision)
    counts = got[..., 0::16]
    assert counts.max() > 0 and counts[0].max() == 0
    empty = counts == 0
    big = float(np.float32(pm.BIG))
    assert bool((got[..., 10::16][empty] == -big).all())
    assert bool((got[..., 11::16][empty] == big).all())
    assert bool((got[..., 10::16][~empty] >= got[..., 11::16][~empty]).all())


def test_sazo_kernel_boundary_and_nan_on_card(cuda):
    # queries and candidates on a 1/8 grid (every f32 operation exact),
    # candidates exactly at a radius above and below a query in z, and
    # one NaN query that counts nothing
    rng = np.random.default_rng(5)
    n_e, q_cap, c_cap, radii = 6, 48, 256, (0.5, 1.0)
    centers = (np.round(rng.random((n_e, 3)) * 200) / 4).astype(np.float32)
    q = rng.integers(-8, 9, (n_e, q_cap, 3)) / 8.0
    c = rng.integers(-16, 17, (n_e, c_cap, 3)) / 8.0
    for i in range(16):
        c[:, i] = q[:, i]
        c[:, i, 2] += radii[i % 2] * (1 if i % 4 < 2 else -1)
    q_t = (q + centers[:, None]).transpose(0, 2, 1).astype(np.float32)
    cand = (c + centers[:, None]).astype(np.float32)
    cand[:, 200:] = pm.FAR
    q_t[1, :, 3] = np.nan
    cand_t = np.ascontiguousarray(cand.reshape(-1, 3).T)
    got = _sazo_case(cuda, np.ascontiguousarray(q_t), cand_t, centers, radii)
    assert int(got[1, 3, 0::16].abs().sum()) == 0
    big = float(np.float32(pm.BIG))
    assert got[1, 3, 10].item() == -big and got[1, 3, 11].item() == big
    # the boundary candidates count, and reach the fold: query i of each
    # entry sees its own at +-r in z
    for i in range(4):
        r = radii[i % 2]
        hi, lo = got[0, i, 16 * (i % 2) + 10], got[0, i, 16 * (i % 2) + 11]
        assert (hi.item() >= r) if i % 4 < 2 else (lo.item() <= -r)


def _with_attrs(cand_t, n_attr, seed):
    """``cand_t`` with ``n_attr`` attribute rows below the coordinates:
    global values of mixed scale and sign, FAR on the dead lanes (as
    the FAR-extended cloud gathers them)."""
    rng = np.random.default_rng(seed)
    dead = cand_t[0] == pm.FAR
    attrs = rng.normal(0, 1, (n_attr, cand_t.shape[1])) \
        * (10.0 ** np.arange(n_attr) % 977)[:, None] + 3.0
    attrs = attrs.astype(np.float32)
    attrs[:, dead] = pm.FAR
    return np.ascontiguousarray(np.concatenate([cand_t, attrs]))


def _attr_case(cuda, q_t, cand_t, centers, radii, n_attr, metric,
               precision="highest"):
    """An attribute (or chebyshev) instance on the card against the twin:
    one launch of its count, counts equal, moment and attribute rows
    within tolerance, finite.  Returns (kernel slabs, twin slabs)."""
    args = [torch.from_numpy(a).to(cuda) for a in (q_t, cand_t, centers)]
    attr = "interp_launches" if metric == "chebyshev" else "attr_launches"
    names = ("launches", "sazo_launches", "attr_launches",
             "interp_launches")
    before = {k: getattr(pm.packed_moments, k) for k in names}
    got = pm.packed_moments(*args, radii, precision=precision,
                            n_attr=n_attr, metric=metric)
    torch.cuda.synchronize()
    after = {k: getattr(pm.packed_moments, k) for k in names}
    assert after == {**before, attr: before[attr] + 1}
    ref = pm.packed_moments_plain(*args, radii, precision=precision,
                                  n_attr=n_attr, metric=metric)
    assert torch.equal(got[..., 0::16], ref[..., 0::16])
    assert ref[..., 0::16].max() > 0
    tol = pm.moment_tolerance(ref, args[1], args[2], n_attr=n_attr)
    assert bool(((got - ref).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())
    for ri in range(len(radii)):          # the rows past the attributes
        assert int(got[..., 16 * ri + 10 + n_attr:16 * ri + 16]
                   .count_nonzero()) == 0
    return got, ref


@pytest.mark.parametrize("q_cap,c_cap,radii,n_attr,precision,scattered", [
    (512, 1024, (1.0,), 2, "highest", False),
    (256, 384, (0.5, 2.0), 1, "highest", True),
    (130, 256, (0.5, 1.0, 1.5), 4, "bf16x2", True),
    (130, 256, (0.5, 1.0, 1.5, 2.0), 6, "highest", False),
    (16, 128, (0.5,), 6, "bf16x2", True),
    (256, 768, (1.0, 0.5), 3, "highest", True),
    (512, 512, (2.0,), 5, "highest", False)])
def test_attr_kernel_matches_plain_on_card(cuda, q_cap, c_cap, radii, n_attr,
                                           precision, scattered):
    q_t, cand_t, centers = _problem(37, q_cap, c_cap, seed=q_cap + n_attr,
                                    scattered=scattered)
    cand_t = _with_attrs(cand_t, n_attr, seed=n_attr)
    got, _ = _attr_case(cuda, q_t, cand_t, centers, radii, n_attr,
                        "euclidean", precision)
    # the count and moment rows are the instance's without attributes,
    # bit for bit: each B column sums on its own
    args = [torch.from_numpy(a).to(cuda) for a in (q_t, cand_t[:3].copy(),
                                                   centers)]
    plain = pm.packed_moments(*args, radii, precision=precision)
    keep = torch.zeros(got.shape[-1], dtype=torch.bool, device=cuda)
    for ri in range(len(radii)):
        keep[16 * ri:16 * ri + 10] = True
    assert torch.equal(got[..., keep], plain[..., keep])


def _interp_problem(n_entries, q_cap, c_cap, radius, n_attr, seed):
    """Chebyshev cases on a 1/8 grid (every f32 operation exact):
    candidates exactly at |d| = r on one axis of a query (0 on the
    others) or 1/8 past it, and a NaN query coordinate on one axis at a
    time."""
    rng = np.random.default_rng(seed)
    centers = (np.round(rng.random((n_entries, 3)) * 200) / 4).astype(
        np.float32)
    q = rng.integers(-8, 9, (n_entries, q_cap, 3)) / 8.0
    c = rng.integers(-16, 17, (n_entries, c_cap, 3)) / 8.0
    for i in range(min(24, q_cap)):
        c[:, i] = q[:, i]
        step = radius + (0.125 if i % 4 == 3 else 0.0)
        c[:, i, i % 3] += step * (1 if i % 2 else -1)
    q_t = (q + centers[:, None]).transpose(0, 2, 1).astype(np.float32)
    cand = (c + centers[:, None]).astype(np.float32)
    cand[:, c_cap * 3 // 4:] = pm.FAR
    for axis in range(3):
        q_t[1, axis, 3 + axis] = np.nan
    cand_t = np.ascontiguousarray(cand.reshape(-1, 3).T)
    return (np.ascontiguousarray(q_t), _with_attrs(cand_t, n_attr, seed),
            centers)


@pytest.mark.parametrize("q_cap,c_cap,n_attr,precision", [
    (128, 1024, 2, "highest"), (128, 384, 1, "highest"),
    (130, 256, 4, "bf16x2"), (16, 128, 6, "highest"),
    (128, 512, 0, "highest"), (256, 640, 5, "bf16x2")])
def test_interp_kernel_matches_plain_on_card(cuda, q_cap, c_cap, n_attr,
                                             precision):
    radius = 0.25
    q_t, cand_t, centers = _interp_problem(23, q_cap, c_cap, radius, n_attr,
                                           seed=q_cap + n_attr)
    got, _ = _attr_case(cuda, q_t, cand_t, centers, (radius,), n_attr,
                        "chebyshev", precision)
    # a NaN on any one axis counts nothing
    for axis in range(3):
        assert float(got[1, 3 + axis].abs().sum()) == 0.0
    # the boundary candidates (|d| = r on one axis) count
    assert bool((got[0, :min(24, q_cap):4, 0] >= 1).all())


def test_chebyshev_on_card_takes_one_radius(cuda):
    q_t, cand_t, centers = (torch.from_numpy(a).to(cuda) for a in
                            _interp_problem(3, 16, 128, 0.25, 1, seed=0))
    with pytest.raises(NotImplementedError):
        pm.packed_moments(q_t, cand_t, centers, (0.25, 0.5), n_attr=1,
                          metric="chebyshev")


def _span_problem(n_entries, q_cap, n_span, span_rows, seed):
    """Spans over a shared cloud: random starts and lengths (a third of
    them empty), lengths up to past ``span_rows`` (clamped)."""
    rng = np.random.default_rng(seed)
    n_pts = 20000
    centers = (rng.random((n_entries, 3)) * 50).astype(np.float32)
    owner = rng.integers(0, n_entries, n_pts)
    pts = (centers[owner] + rng.uniform(-3, 3, (n_pts, 3))).astype(
        np.float32)
    order = np.argsort(owner, kind="stable")
    pts, owner = pts[order], owner[order]
    first = np.searchsorted(owner, np.arange(n_entries))
    size = np.bincount(owner, minlength=n_entries)
    lens = rng.integers(0, span_rows + 8, (n_entries, n_span))
    lens[rng.random((n_entries, n_span)) < 1 / 3] = 0
    lens = np.minimum(lens, size[:, None])
    starts = first[:, None] + (rng.random((n_entries, n_span))
                               * (size[:, None] - lens + 1)).astype(int)
    q_local = rng.uniform(-2, 2, (n_entries, q_cap, 3)).astype(np.float32)
    return (q_local, centers, starts.astype(np.int32),
            lens.astype(np.int32), pts)


@pytest.mark.parametrize("q_cap,n_span,span_rows,radii,precision", [
    (256, 25, 3136, (0.5,), "highest"), (130, 9, 64, (0.5, 2.0), "highest"),
    (16, 100, 40, (0.5, 1.0, 1.5, 2.0), "highest"),
    (130, 25, 40, (0.5, 1.0, 1.5, 2.0), "bf16x2"),
    (256, 9, 64, (1.0,), "bf16x2")])
def test_span_kernel_matches_plain_on_card(cuda, q_cap, n_span, span_rows,
                                           radii, precision):
    args = [torch.from_numpy(a).to(cuda) for a in
            _span_problem(41, q_cap, n_span, span_rows, seed=q_cap + n_span)]
    # a ragged tail: most entries' live rows are not a multiple of 16
    totals = torch.clamp(args[3], 0, span_rows).sum(1)
    assert int((totals % 16 != 0).sum()) > 20
    before = gk.span_moments.launches
    got = gk.span_moments(*args, radii, span_rows, precision=precision)
    torch.cuda.synchronize()
    assert gk.span_moments.launches == before + 1
    ref = gk.span_moments_plain(*args, radii, span_rows, precision=precision)
    counts = slice(0, None, 16)
    assert torch.equal(got[..., counts], ref[..., counts])
    assert ref[..., counts].max() > 0
    tol = gk.span_tolerance(ref, *args[1:], span_rows)
    assert bool(((got - ref).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())


def _entry_case(cuda, q_cap, flat, radii, layout, exact=False, nan=False):
    """The kernel on an ``entry_problem`` of 19 entries against the plain
    twin: one launch, counts equal.  Returns (kernel slabs, twin slabs,
    the inputs on the card)."""
    arrays = entry_problem(19, q_cap, flat, radii, seed=q_cap + flat,
                           layout=layout, exact=exact)
    if nan:
        arrays = with_nan(*arrays)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = mk.entry_moments.launches
    got = mk.entry_moments(*args, radii)
    torch.cuda.synchronize()
    assert mk.entry_moments.launches == before + 1
    ref = mk.entry_moments_plain(*args, radii)
    counts = slice(0, None, 16)
    assert torch.equal(got[..., counts], ref[..., counts])
    return got, ref, args


# the tiled layout at the bench's F = 125 x 8; F of two compaction
# passes (5000, 9000), with rows carried from one pass to the next
# (sparse: no tile filled in a pass); F not a multiple of 16; q_cap
# 130 and 512; 1-4 radii; candidates exactly on the boundary
@pytest.mark.parametrize("q_cap,flat,radii,layout,exact", [
    (512, 1000, (0.5,), "tiled", False),
    (130, 1000, (0.5, 1.0), "tiled", False),
    (256, 4000, (0.5,), "random", False),
    (100, 1000, (1.0, 0.5), "random", False),
    (16, 300, (0.5, 1.0, 1.5, 2.0), "random", False),
    (130, 5000, (0.5, 1.0, 1.5), "random", False),
    (512, 5000, (1.0,), "tiled", False),
    (64, 9000, (0.5, 2.0), "sparse", False),
    (64, 1003, (0.5, 1.0, 1.5, 2.0), "tiled", False),
    (130, 250, (0.5, 1.0, 2.0), "random", True),
    (512, 1000, (0.5,), "tiled", True)])
def test_entry_kernel_matches_plain_on_card(cuda, q_cap, flat, radii,
                                            layout, exact):
    got, ref, args = _entry_case(cuda, q_cap, flat, radii, layout, exact)
    counts = slice(0, None, 16)
    assert ref[..., counts].max() > 0
    assert int(ref[0, :, counts].abs().sum()) == 0       # no valid slot
    assert ref[1, :, counts].max() > 0                   # all valid
    tol = mk.entry_tolerance(ref, args[1], args[2])
    assert bool(((got - ref).abs() <= tol).all())
    assert bool(torch.isfinite(got).all())


def test_entry_kernel_nan_counts_match_plain_on_card(cuda):
    # a NaN query counts nothing, a NaN candidate is nobody's neighbor
    # (the reference's comparison is false for NaN); moments at NaN
    # inputs are not held
    got, ref, _ = _entry_case(cuda, 130, 250, (0.5, 2.0), "random",
                              exact=True, nan=True)
    assert int(got[:, 1, 0::16].abs().sum()) == 0
    assert got[:, 0, 0::16].max() > 0


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_serving_on_card_matches_cpu(cuda, backend):
    _serve_card_and_cpu(cuda, backend, "minimal")


def test_sazo_serving_on_card_matches_cpu(cuda):
    before = pm.packed_moments.sazo_launches
    _serve_card_and_cpu(cuda, "packed", "sazo")
    assert pm.packed_moments.sazo_launches > before


def test_vector_serving_on_card_matches_cpu(cuda):
    before = (pm.packed_moments.attr_launches,
              pm.packed_moments.interp_launches)
    _serve_card_and_cpu(cuda, "packed", "vector")
    assert pm.packed_moments.attr_launches > before[0]
    assert pm.packed_moments.interp_launches > before[1]


def _serve_card_and_cpu(cuda, backend, kind):
    cloud, labels = workload.make_bench_cloud(30000, seed=0)
    attrs = workload.make_bench_attributes(labels) if kind == "vector" \
        else None
    gpu = workload.make_bench_model(cloud, backend=backend, kind=kind,
                                    device=cuda)
    gpu.fit(cloud, labels, sample=15000, attributes=attrs)
    clf = gpu.classifier
    cpu = workload.make_bench_model(cloud, backend=backend, kind=kind,
                                    device="cpu")
    cpu.install_classifier(SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu"), cloud, attributes=attrs)
    a, pa = gpu.predict_staged(gpu.stage(cloud, attributes=attrs),
                               with_proba=True)
    b = cpu.predict_staged(cpu.stage(cloud, attributes=attrs))
    top2 = torch.sort(pa.cpu(), dim=1).values[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    differ = a.cpu() != b
    assert not bool((differ & ~near_tie).any())
    assert int(differ.sum()) <= 0.001 * len(cloud)


# -- exclude_radius -----------------------------------------------------------

EXCL_COUNTS = ("launches", "sazo_launches", "attr_launches",
               "interp_launches", "excl_launches", "excl_sazo_launches",
               "excl_attr_launches")


def _bit_equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("variant", ["plain", "sazo", "attr1", "attr4",
                                     "attr6"])
@pytest.mark.parametrize("exclude_radius", excl.EXCLUDE_RADII)
@pytest.mark.parametrize("precision", ["highest", "bf16x2"])
def test_packed_exclusion_matches_plain_on_card(cuda, variant,
                                                exclude_radius, precision):
    kw = {"plain": {}, "sazo": {"with_sazo": True}, "attr1": {"n_attr": 1},
          "attr4": {"n_attr": 4}, "attr6": {"n_attr": 6}}[variant]
    arrays = excl.packed_problem(37, 130, 256, (0.5, 1.0), seed=11,
                                 n_attr=kw.get("n_attr", 0))
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    family = "excl_" + ("sazo_launches" if "with_sazo" in kw
                        else "attr_launches" if "n_attr" in kw
                        else "launches")
    before = {k: getattr(pm.packed_moments, k) for k in EXCL_COUNTS}
    got = pm.packed_moments(*args, (0.5, 1.0), exclude_radius=exclude_radius,
                            precision=precision, **kw)
    torch.cuda.synchronize()
    after = {k: getattr(pm.packed_moments, k) for k in EXCL_COUNTS}
    assert after == {**before, family: before[family] + 1}
    ref = pm.packed_moments_plain(*args, (0.5, 1.0),
                                  exclude_radius=exclude_radius,
                                  precision=precision, **kw)
    assert torch.equal(got[..., 0::16], ref[..., 0::16])
    assert ref[..., 0::16].max() > 0
    live = slice(0, 36)                  # the last entry holds NaN
    tol = pm.moment_tolerance(ref[live], args[1][:, :36 * 256], args[2][live],
                              n_attr=kw.get("n_attr", 0))
    assert bool(((got[live] - ref[live]).abs() <= tol).all())
    if "with_sazo" in kw:
        for row in (10, 11):
            assert torch.equal(got[live, :, row::16], ref[live, :, row::16])
    if exclude_radius == 0.0:
        # the same mask and the same sum order as without the exclusion
        _bit_equal(got, pm.packed_moments(*args, (0.5, 1.0),
                                          precision=precision, **kw))


@pytest.mark.parametrize("exclude_radius", excl.EXCLUDE_RADII)
@pytest.mark.parametrize("precision", ["highest", "bf16x2"])
def test_span_exclusion_matches_plain_on_card(cuda, exclude_radius,
                                              precision):
    args = [torch.from_numpy(a).to(cuda) for a in
            excl.span_problem(41, 130, 25, 40, (0.5, 1.0), seed=9)]
    before = (gk.span_moments.launches, gk.span_moments.excl_launches)
    got = gk.span_moments(*args, (0.5, 1.0), 40,
                          exclude_radius=exclude_radius, precision=precision)
    torch.cuda.synchronize()
    assert (gk.span_moments.launches, gk.span_moments.excl_launches) \
        == (before[0], before[1] + 1)
    ref = gk.span_moments_plain(*args, (0.5, 1.0), 40,
                                exclude_radius=exclude_radius,
                                precision=precision)
    assert torch.equal(got[..., 0::16], ref[..., 0::16])
    assert ref[..., 0::16].max() > 0
    tol = gk.span_tolerance(ref, *args[1:], 40)
    assert bool(((got - ref).abs() <= tol).all())
    if exclude_radius == 0.0:
        _bit_equal(got, gk.span_moments(*args, (0.5, 1.0), 40,
                                        precision=precision))


@pytest.mark.parametrize("exclude_radius", excl.EXCLUDE_RADII)
@pytest.mark.parametrize("q_cap,flat,radii", [
    (512, 1000, (0.5,)), (130, 5000, (0.5, 1.0, 1.5)),
    (64, 300, (0.5, 1.0, 1.5, 2.0))])
def test_entry_exclusion_matches_plain_on_card(cuda, exclude_radius, q_cap,
                                               flat, radii):
    args = [torch.from_numpy(a).to(cuda) for a in
            excl.entry_problem(19, q_cap, flat, radii, seed=q_cap)]
    before = (mk.entry_moments.launches, mk.entry_moments.excl_launches)
    got = mk.entry_moments(*args, radii, exclude_radius=exclude_radius)
    torch.cuda.synchronize()
    assert (mk.entry_moments.launches, mk.entry_moments.excl_launches) \
        == (before[0], before[1] + 1)
    ref = mk.entry_moments_plain(*args, radii,
                                 exclude_radius=exclude_radius)
    assert torch.equal(got[..., 0::16], ref[..., 0::16])
    assert ref[1:, :, 0::16].max() > 0
    tol = mk.entry_tolerance(ref, args[1], args[2])
    assert bool(((got - ref).abs() <= tol).all())
    if exclude_radius == 0.0:
        _bit_equal(got, mk.entry_moments(*args, radii))


@pytest.mark.parametrize("exclude_radius", [0.0, 1e-30])
def test_entry_exclusion_clamps_negative_d2_on_card(cuda, exclude_radius):
    q, s, valid, d2 = excl.clamp_problem()
    assert d2 < 0
    got = mk.entry_moments(*(torch.from_numpy(a).to(cuda)
                             for a in (q, s, valid)), (0.5,),
                           exclude_radius=exclude_radius)
    # the negative-d2 pair counts (max.NaN clamp); the NaN query and the
    # NaN candidate count nowhere
    assert got[0, 0, 0].item() == 1
    assert got[0, 1:, 0].abs().sum().item() == 0


def test_exclusion_serving_on_card_matches_cpu(cuda):
    cloud, labels = workload.make_bench_cloud(30000, seed=0)
    gpu = workload.make_bench_model(cloud, device=cuda, exclude_radius=0.1)
    before = pm.packed_moments.excl_launches
    gpu.fit(cloud, labels, sample=15000)
    assert pm.packed_moments.excl_launches > before
    clf = gpu.classifier
    cpu = workload.make_bench_model(cloud, device="cpu", exclude_radius=0.1)
    cpu.install_classifier(SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu"), cloud)
    a, diag = gpu.predict_device(cloud, with_diag=True)
    assert all(int(v) == 0 for v in diag.values())
    pa = gpu.predict_proba_device(cloud)
    b = cpu.predict_device(cloud)
    top2 = torch.sort(pa.cpu(), dim=1).values[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    differ = a.cpu() != b
    assert not bool((differ & ~near_tie).any())
    assert int(differ.sum()) <= 0.001 * len(cloud)


# -- designated search and the host runtime -----------------------------------

def _drive_scene(per=400, seed=21):
    """tests/test_drive_matrix.py's scene (a sheet, a line, a blob) and a
    designated search map, the cloud jittered by 2 cm."""
    rng = np.random.default_rng(seed)
    cloud = np.vstack([rng.random((per, 3)) * [8, 8, 0.02],
                       rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0],
                       rng.normal([16, 4, 4], 1.0, (per, 3))]
                      ).astype(np.float32)
    labels = np.repeat([0, 1, 2], per).astype(np.int32)
    search = (cloud + rng.normal(0, 0.02, cloud.shape)).astype(np.float32)
    return cloud, labels, search


def test_designated_serving_on_card_matches_cpu(cuda):
    from nimrud_tpu_torch.pipeline import GeometryClassifier

    cloud, labels, search = _drive_scene()
    lo = np.minimum(cloud.min(0), search.min(0)) - 0.37
    hi = np.maximum(cloud.max(0), search.max(0)) + 0.53
    config = dict(kind="minimal", classifier="linear",
                  classifier_kwargs={"epochs": 10, "seed": 0},
                  transfer_dtype="uint16", backend="packed",
                  bounds=(lo, hi), trim_entries=True)
    gpu = GeometryClassifier([(0.2, (0.8, 0.4))], device=cuda, **config)
    gpu.fit(cloud, labels, search=search)
    handle = gpu.stage_search(search)
    assert gpu.search_overflow(handle) == {"vox_dropped": 0,
                                           "interp_dropped": 0}
    before = pm.packed_moments.launches
    served, diag = gpu.predict_staged(gpu.stage(cloud, staged_search=handle),
                                      with_diag=True)
    assert pm.packed_moments.launches > before
    assert all(int(v) == 0 for v in diag.values()), diag
    assert torch.equal(served, gpu.predict_staged(
        gpu.stage(cloud, search=search)))
    # the stream stages on a side stream: the same labels as one at a time
    rng = np.random.default_rng(7)
    clouds = [cloud] + [(cloud + rng.normal(0, 0.01, cloud.shape))
                        .astype(np.float32) for _ in range(3)]
    for c, got in zip(clouds, gpu.predict_stream(clouds,
                                                 staged_search=handle)):
        assert torch.equal(got, gpu.predict_staged(
            gpu.stage(c, staged_search=handle)))
    clf = gpu.classifier
    cpu = GeometryClassifier([(0.2, (0.8, 0.4))], device="cpu", **config)
    cpu.install_classifier(SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu"), cloud, search=search)
    _, probs = gpu.predict_staged(gpu.stage(cloud, staged_search=handle),
                                  with_proba=True)
    on_cpu = cpu.predict_staged(cpu.stage(cloud,
                                          staged_search=cpu.stage_search(
                                              search)))
    top2 = torch.sort(probs.cpu(), dim=1).values[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    differ = served.cpu() != on_cpu
    assert not bool((differ & ~near_tie).any())


def test_native_stage_on_card_equals_numpy_stage(cuda):
    cloud, labels = workload.make_bench_cloud(30000, seed=0)
    gpu = workload.make_bench_model(cloud, device=cuda)
    gpu.fit(cloud, labels, sample=15000)
    other, _ = workload.make_bench_cloud(30000, seed=1)
    native_st = gpu.stage(other)
    numpy_st = gpu.stage(other, impl="numpy")
    assert native_st["query"].dtype == torch.int16
    assert torch.equal(native_st["query"], numpy_st["query"])
    assert torch.equal(native_st["dequant"], numpy_st["dequant"])
    assert torch.equal(gpu.predict_staged(native_st),
                       gpu.predict_staged(numpy_st))


# -- entry-chunked serving and the forest -------------------------------------

def test_chunked_serving_on_card_equals_unchunked(cuda):
    from nimrud_tpu_torch import pipeline
    cloud, labels = workload.make_bench_cloud(30000, seed=0)
    whole = workload.make_bench_model(cloud, device=cuda)
    whole.fit(cloud, labels, sample=15000)
    chunked = workload.make_bench_model(cloud, device=cuda,
                                        serving_chunk_slots=256 * 512)
    chunked.install_classifier(whole.classifier, cloud)
    pack = min((b[1] for b in chunked._spec_cache[1]),
               key=lambda spec: spec.tile_edge)
    assert pipeline._serving_entry_chunk(pack.e_cap, pack.q_cap,
                                         256 * 512) < pack.e_cap
    before = pm.packed_moments.launches
    got, probs, diag = chunked.predict_staged(
        chunked.stage(cloud), with_proba=True, with_diag=True)
    assert pm.packed_moments.launches > before
    assert all(int(v) == 0 for v in diag.values()), diag
    want, want_probs = whole.predict_staged(whole.stage(cloud),
                                            with_proba=True)
    assert torch.equal(got, want)
    assert float((probs - want_probs).abs().max()) <= \
        checks.CHUNK_PROBA_TOLERANCE


def _walk_card_and_cpu(gpu, x):
    """The forest ``gpu`` walked on the card and its copy on the CPU:
    probabilities within 1e-6 and labels equal except at rows the walk
    witness holds."""
    cpu = checks.on_cpu(gpu)
    got = gpu.proba_device(torch.from_numpy(x).to(gpu.device)).cpu()
    want = cpu.proba_device(torch.from_numpy(x))
    off = ((got - want).abs().amax(1) > 1e-6) \
        | (got.argmax(1) != want.argmax(1))
    rows = off.nonzero()[:, 0]
    held = checks.walk_witness(cpu._tables, torch.from_numpy(x),
                                    cpu.max_depth_, rows)
    assert bool(held.all()), rows[~held]
    assert len(rows) <= 0.001 * len(x)


def test_forest_fit_and_walks_on_card_match_cpu(cuda):
    (x, y), (xt, _) = forest_data(3000, 0), forest_data(4000, 1)
    gpu = RPTEnsemble(seed=0).fit_device(torch.from_numpy(x).to(cuda), y,
                                         n_classes=3)
    assert gpu._tables["dense_splits"].device.type == cuda.type
    again = RPTEnsemble(seed=0).fit_device(torch.from_numpy(x).to(cuda), y,
                                           n_classes=3)
    for key, value in gpu._tables.items():
        assert torch.equal(value, again._tables[key]), key
    _walk_card_and_cpu(gpu, xt)                       # the dense walk
    host = RPTEnsemble(seed=0, device=cuda).fit(x, y)
    assert "dense_splits" not in host._tables
    _walk_card_and_cpu(host, xt)                      # the sparse walk


def test_rpte_serving_on_card_matches_cpu(cuda):
    cloud, labels = workload.make_bench_cloud(30000, seed=0)
    gpu = workload.make_bench_model(cloud, classifier="rpte", device=cuda)
    gpu.fit(cloud, labels, sample=15000)
    cpu = workload.make_bench_model(cloud, device="cpu")
    cpu.install_classifier(checks.on_cpu(gpu.classifier), cloud)
    before = pm.packed_moments.launches
    staged = gpu.stage(cloud)
    got, diag = gpu.predict_staged(staged, with_diag=True)
    assert pm.packed_moments.launches > before
    assert all(int(v) == 0 for v in diag.values()), diag
    assert float((got.cpu().numpy() == labels).mean()) > 0.8
    # the card's labels are the CPU walk's of the card's own rows, except
    # where the walk witness holds the row
    feats = checks.served_features(gpu, staged).cpu()
    walked = cpu.classifier.proba_device(feats).argmax(1)
    rows = (walked != got.cpu()).nonzero()[:, 0]
    assert bool(checks.walk_witness(
        cpu.classifier._tables, feats, cpu.classifier.max_depth_,
        rows).all())
    differ = got.cpu() != cpu.predict_staged(cpu.stage(cloud))
    assert int(differ.sum()) <= 0.001 * len(cloud)


# -- the XLA path and the dense method ----------------------------------------

def _xla_clouds(seed=31):
    rng = np.random.default_rng(seed)
    search = (rng.random((6000, 3)) * (12, 12, 4)).astype(np.float32)
    query = (rng.random((2000, 3)) * (12, 12, 4)).astype(np.float32)
    return query, search, rng.random((6000, 3)).astype(np.float32)


@pytest.mark.parametrize("kind,metric,attrs", [
    ("minimal", "euclidean", False), ("sazo", "euclidean", False),
    ("eigen", "chebyshev", False), ("vector", "chebyshev", True)])
def test_xla_tile_path_on_card_matches_cpu(cuda, kind, metric, attrs):
    from nimrud_tpu_torch.ops import grid
    query, search, attributes = _xla_clouds()
    problem = grid.build_tiled_problem(query, search, 1.0,
                                       query_tile_factor=3, entry_batch=64)
    kw = dict(attributes=attributes if attrs else None, metric=metric,
              entry_batch=64, exclude_radius=0.05)
    before = mk.entry_moments.launches + mk.entry_moments.excl_launches
    got = grid.tiled_features(problem, query, search, (1.0, 0.6), kind,
                              device=cuda, **kw).cpu()
    assert mk.entry_moments.launches + mk.entry_moments.excl_launches \
        == before
    ref = grid.tiled_features(problem, query, search, (1.0, 0.6), kind,
                              device="cpu", **kw)
    if kind != "vector":
        from nimrud_tpu_torch.features import layouts
        width = got.shape[1] // 2
        # the same d2 in the same order on both: populations equal
        assert torch.allclose(got[:, 0::width], ref[:, 0::width],
                              rtol=2.0 ** -22, atol=0)
        # the columns the layout leaves to rounding, taken from the CPU
        got = layouts.reconcile(kind, got, ref)[0]
    assert torch.allclose(got, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("metric,sazo", [("euclidean", True),
                                         ("chebyshev", False)])
def test_dense_method_on_card_matches_cpu(cuda, metric, sazo):
    from nimrud_tpu_torch.ops import moments
    query, search, attributes = _xla_clouds(seed=32)
    valid = torch.arange(len(search)) < len(search) - 100
    args = [torch.from_numpy(query[:1024]), torch.from_numpy(search), valid,
            (1.0, 0.5)]
    kw = dict(attributes=torch.from_numpy(attributes), chunk_size=256,
              exclude_radius=0.1, metric=metric, with_sazo=sazo)
    got = moments.multiscale_moments(*(a.to(cuda) if torch.is_tensor(a)
                                       else a for a in args),
                                     **{k: v.to(cuda) if torch.is_tensor(v)
                                        else v for k, v in kw.items()})
    ref = moments.multiscale_moments(*args, **kw)
    assert torch.equal(got["count"].cpu(), ref["count"])
    if sazo:
        assert torch.equal(got["sazo"].cpu(), ref["sazo"])
    for key, atol in (("mean", 5e-5), ("cov", 2e-4), ("attr_mean", 2e-5)):
        assert torch.allclose(got[key].cpu(), ref[key], atol=atol), key


def test_xla_serving_on_card_matches_cpu(cuda):
    cloud, labels = workload.make_bench_cloud(12000, seed=0)
    cloud = (cloud * np.float32([0.2, 0.2, 1.0])).astype(np.float32)
    gpu = workload.make_bench_model(cloud, backend="xla", device=cuda)
    counts = (pm.packed_moments.launches, gk.span_moments.launches,
              mk.entry_moments.launches)
    gpu.fit(cloud, labels, sample=6000)
    cpu = workload.make_bench_model(cloud, backend="xla", device="cpu")
    cpu.install_classifier(checks.on_cpu(gpu.classifier), cloud)
    got, proba, diag = gpu.predict_staged(gpu.stage(cloud), with_proba=True,
                                          with_diag=True)
    assert (pm.packed_moments.launches, gk.span_moments.launches,
            mk.entry_moments.launches) == counts
    assert all(int(v) == 0 for v in diag.values()), diag
    assert float((got.cpu().numpy() == labels).mean()) > 0.8
    top2 = torch.sort(proba.cpu(), dim=1).values[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    differ = got.cpu() != cpu.predict_staged(cpu.stage(cloud))
    assert not bool((differ & ~near_tie).any())
    assert int(differ.sum()) <= 0.001 * len(cloud)


def test_neighbor_ties_and_boundary_on_card(cuda):
    from nimrud_tpu_torch.ops import neighbors
    from torch_neighbor_cases import boundary_radius, tie_case
    query, search = tie_case()
    for fn, args in (("knn", (5, 0.5)), ("radius_neighbors", (0.125, 6))):
        got = getattr(neighbors, fn)(query, search, *args, device=cuda)
        ref = getattr(neighbors, fn)(query, search, *args, device="cpu")
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for below in (False, True):
        query, search, target, radius, _ = boundary_radius(below)
        got = neighbors.radius_neighbors(query, search, radius, device=cuda)
        ref = neighbors.radius_neighbors(query, search, radius, device="cpu")
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        inside = set(got["indices"][0][got["valid"][0]].tolist())
        assert (target in inside) != below


def test_knn_features_on_card_match_cpu(cuda):
    from nimrud_tpu_torch.features.knn import knn_features
    from nimrud_tpu_torch.ops import neighbors
    cloud, _ = workload.make_bench_cloud(20000, seed=3)
    cloud = (cloud * np.float32([0.2, 0.2, 1.0])).astype(np.float32)
    got = neighbors.knn(cloud[:4000], cloud, 16, 0.5, device=cuda)
    ref = neighbors.knn(cloud[:4000], cloud, 16, 0.5, device="cpu")
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for kind in ("minimal", "eigen"):
        a = knn_features(cloud[:4000], cloud, 16, 0.5, kind=kind,
                         device=cuda)
        b = knn_features(cloud[:4000], cloud, 16, 0.5, kind=kind,
                         device="cpu")
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_host_classifier_route_on_card(cuda):
    # 20000 points: the fused method (the packed kernel) from 16384 up
    cloud, labels = workload.make_bench_cloud(20000, seed=0)
    counts = (pm.packed_moments.launches, gk.span_moments.launches,
              mk.entry_moments.launches)
    gpu = workload.make_bench_model(cloud, classifier=checks.NearestMean(),
                                    device=cuda)
    gpu.fit(cloud, labels, sample=6000)
    got = gpu.predict_device(cloud)
    assert pm.packed_moments.launches > counts[0]
    assert (gk.span_moments.launches, mk.entry_moments.launches) \
        == counts[1:]
    with pytest.raises(ValueError, match="host classifier"):
        gpu.stage(cloud)
    proba = gpu.predict_proba_device(cloud)
    assert proba.dtype == torch.float32 and proba.device.type == "cuda"
    want = np.asarray(gpu.classifier.predict_proba(gpu.extract(cloud)),
                      np.float32).argmax(1)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert float((got.cpu().numpy() == labels).mean()) > 0.8
    cpu = workload.make_bench_model(cloud, device="cpu")
    cpu.install_classifier(gpu.classifier, cloud)
    agree = float((cpu.predict(cloud) == got.cpu().numpy()).mean())
    assert agree >= 0.999, agree


# -- the multi-device layer ---------------------------------------------------

def _mesh_of(device, shape=(2, 2)):
    """A (2, 2) mesh whose four entries are one device."""
    from nimrud_tpu_torch.parallel import mesh as pmesh
    return pmesh.make_mesh_2d(shape, devices=[device] * (shape[0] * shape[1]))


@pytest.mark.parametrize("backend,kernel", [("packed", pm.packed_moments),
                                            ("pallas", gk.span_moments)])
def test_multichip_serving_on_card_matches_cpu_mesh(cuda, backend, kernel):
    from nimrud_tpu_torch.pipeline import GeometryClassifier
    cloud, labels, _ = _drive_scene(per=500)
    kw = {"backend": backend, "bounds": (cloud.min(0), cloud.max(0))}
    gpu = GeometryClassifier([(0.2, (0.8, 0.4))], device=cuda,
                             classifier_kwargs={"epochs": 25, "seed": 0},
                             **kw)
    gpu.fit(cloud, labels)
    clf = gpu.classifier
    cpu = GeometryClassifier([(0.2, (0.8, 0.4))], device="cpu", **kw)
    cpu.install_classifier(SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu"), cloud)
    before = kernel.launches
    got = gpu.predict_multichip(cloud, (2, 2), mesh=_mesh_of(cuda))
    assert kernel.launches > before
    want = cpu.predict_multichip(cloud, (2, 2),
                                 mesh=_mesh_of(torch.device("cpu")))
    assert float((got == want).mean()) >= 0.999
    assert float((got == labels).mean()) > 0.9


def test_sharded_extract_2d_on_card_matches_cpu_mesh(cuda):
    from nimrud_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(41)
    points = (rng.random((4000, 3)) * [12, 6, 3]).astype(np.float32)
    got, want = (pmesh.extract_multichip_2d(
        points, (0.5, 0.25), mesh_shape=(2, 2), mesh=_mesh_of(device))
        for device in (cuda, torch.device("cpu")))
    np.testing.assert_array_equal(got[:, [0, 4]], want[:, [0, 4]])
    sturdy = np.all(got[:, [0, 4]] >= 3, axis=1)
    np.testing.assert_allclose(got[sturdy], want[sturdy], atol=2e-3)


def test_fit_device_mesh_on_card_bit_equal_to_fit_device(cuda):
    from nimrud_tpu_torch.parallel import mesh as pmesh
    rng = np.random.default_rng(4)
    feats = rng.random((4, 300, 6)).astype(np.float32)
    valid = rng.random((4, 300)) > 0.2
    labels = rng.integers(0, 3, (4, 300)).astype(np.int32)
    single = RPTEnsemble(n_estimators=5, seed=11).fit_device(
        torch.from_numpy(feats[valid]).to(cuda), labels[valid])
    dist = RPTEnsemble(n_estimators=5, seed=11).fit_device_mesh(
        feats, valid, labels, pmesh.make_mesh(4, devices=[cuda] * 4))
    for key, value in single._tables.items():
        assert torch.equal(dist._tables[key], value), key


def test_bench_headline_on_card(cuda, capsys):
    from nimrud_tpu_torch.bench import headline
    line = headline.main(["--points", "100000"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1])["value"] == line["value"] > 0
    assert line["device"] == torch.cuda.get_device_name(0)
    # launches_total counts from the process's start: earlier tests' too
    assert set(line["launches_per_step"]) == {"packed_moments"}
    assert line["launches_per_step"]["packed_moments"] > 0
    assert line["counters_all_zero"]
    trace = line["trace"]
    assert 0 < trace["busy_ms_per_step"] <= trace["window_ms_per_step"]
    assert line["roofline"]["window_ms"] == trace["window_ms_per_step"]
    assert line["train_accuracy"] > 0.8


def test_bench_density_urban_on_card(cuda, capsys):
    from nimrud_tpu_torch.bench import density
    line = density.main(["urban", "--points", "100000"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1])["mode"] == line["mode"] == "density_urban"
    assert line["device"] == torch.cuda.get_device_name(0)
    # launches_total counts from the process's start: earlier tests' too
    assert set(line["launches_per_step"]) == {"packed_moments"}
    assert line["counters_all_zero"]
    assert any(len(band["caps"]) > 1 for band in line["cap_buckets_per_band"])
    assert [row["edge"] for row in line["plan_occupancy"]] \
        == list(workload.BENCH_EDGES)
