"""
Masked moment slabs over dense packed candidate blocks: the port of the
TPU kernel ``nimrud_tpu/ops/pallas/packed_kernel.py:packed_moments``.

Two versions with one signature and one output layout:

* :func:`packed_moments_plain` -- plain PyTorch (broadcast distances and
  a masked ``matmul``), looped over entry chunks so a full band fits on
  the card.  It is the oracle: the CPU tests hold it against the JAX
  kernel, and ``chip_smoke.py`` holds the CUDA kernel against it.
* :func:`packed_moments` -- the wrapper of the hand-written Hopper
  kernel ``csrc/packed_moments.cu`` (design notes at its top; the
  masked sums run on the tensor cores, ``csrc/moment_mma.cuh``).  A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernel
  or raises.  ``packed_moments.launches`` counts kernel launches.

The kernel is built by ``cuda_build`` at first use and loaded through
ctypes.

Ported: the euclidean metric, with or without the sazo rows
(``with_sazo``: slab rows 10 / 11 of each radius hold the masked max /
min of the signed z offset ``s_z - q_z``, ``-BIG`` / ``+BIG`` where no
candidate is inside) or up to six attribute rows (``n_attr``: candidate
rows 3..3+A of ``cand_t``, global values, summed under the same mask
into slab rows 10..10+A: the numerator of the V_MSO attribute mean);
and the chebyshev metric (``max(|dx|, |dy|, |dz|) <= r``, the packed
attribute interp's ball) with attribute rows, at ``precision="highest"``
or ``"bf16x2"`` (the plain version sums bf16 hi + mid + lo parts as the
reference does; the kernel computes that split for both precisions).
``exclude_radius`` keeps only the pairs with ``f32(e*e) <= d2`` (the
reference's legacy self-exclusion) in the euclidean instances, with or
without sazo or attribute rows; sazo with attributes, and chebyshev
with sazo or ``exclude_radius``, raise ``ValueError`` as in the
reference.  Launch counts, one per instance family:
``packed_moments.launches`` (euclidean, no sazo, no attributes),
``sazo_launches`` (the sazo instance), ``attr_launches`` (euclidean
with attribute rows: the vector extraction), ``interp_launches``
(chebyshev: the packed attribute interp), and the exclusion instances
``excl_launches``, ``excl_sazo_launches`` and ``excl_attr_launches``.
"""

import ctypes
import functools

import torch

from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import (
    DISTANCE_OPS, EXCLUSION_OPS, MAX_ATTR, MOMENT_COLS, MOMENT_PAD,
    PAIR_BUDGET, check_launch, check_precision, check_radii, check_tensors,
    chebyshev_radii, exclusion_args, exclusion_threshold, masked_sum,
    moment_bound, padded_radii, slab_bytes, slab_tolerance, squared_radii)

LANES = 128            # c_cap granularity (the packing contract)
FAR = 1.0e6            # dead-slot sentinel: d2 >= 1e12 fails every
                       # radius, and 3 * FAR^2 stays finite in f32
BIG = 1.0e30           # identity of the sazo max / min folds
SAZO_OPS = 2           # CUDA-core operations of the sazo fold a pair and
                       # radius: a masked max and a masked min
CHEBYSHEV_OPS = 5      # the max-norm distance: 3 sub and 2 max, the three
                       # |.| being sign-bit operand modifiers of the max
METRICS = ("euclidean", "chebyshev")


def attr_slots(n_attr):
    """Attribute rows of the kernel instance that carries ``n_attr``:
    its tensor-core B operand holds the count, 9 moment terms and the
    slots in three bf16 parts each, rounded up to the n8 tile (32
    columns hold 1 slot, 40 hold 4, 48 hold 6)."""
    return 1 if n_attr <= 1 else 4 if n_attr <= 4 else MAX_ATTR


def _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric):
    if with_sazo and n_attr:
        raise ValueError("sazo and attributes both claim slab rows 10+")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "chebyshev" and (with_sazo or exclude_radius is not None):
        raise ValueError("chebyshev masks support neither sazo nor "
                         "exclude_radius")
    if not 0 <= n_attr <= MAX_ATTR:
        raise ValueError(
            f"packed kernel fits at most {MAX_ATTR} attributes")
    check_precision(precision)
    check_radii(radii)


def _shapes(q_t, cand_t, centers, n_attr=0):
    if q_t.dim() != 3 or q_t.shape[1] != 3:
        raise ValueError(f"q_t must be (E, 3, q_cap), got {tuple(q_t.shape)}")
    n_entries, _, q_cap = q_t.shape
    if cand_t.dim() != 2 or cand_t.shape[0] != 3 + n_attr:
        raise ValueError("cand_t must carry 3 + n_attr rows (x, y, z, "
                         "attributes)")
    if centers.shape != (n_entries, 3):
        raise ValueError("centers must be (E, 3)")
    c_cap = cand_t.shape[1] // max(n_entries, 1)
    if c_cap * n_entries != cand_t.shape[1]:
        raise ValueError("cand_t lane count must be E * c_cap")
    if c_cap % LANES:
        raise ValueError(f"c_cap must be a multiple of {LANES}")
    return n_entries, q_cap, c_cap


def _thresholds(radii, metric):
    """The f32 values the distances are compared with: f32(r*r), or
    f32(r) for the chebyshev metric."""
    if metric == "chebyshev":
        return chebyshev_radii(radii)[:len(radii)]
    return [float(v) for v in squared_radii(radii)]


def packed_moments_plain(q_t, cand_t, centers, radii, exclude_radius=None,
                         precision="highest", with_sazo=False, n_attr=0,
                         metric="euclidean"):
    """
    Raw masked moment slabs, plain PyTorch.

    Args:
      q_t:     (E, 3, q_cap) f32 global-frame queries, coordinate axis
               second.
      cand_t:  (3 + n_attr, E * c_cap) f32 global-frame candidates
               (rows x, y, z, then the attributes); entry e owns lanes
               [e*c_cap, (e+1)*c_cap), dead slots hold FAR.  c_cap is a
               multiple of 128.
      centers: (E, 3) f32 entry centers; the entry-local frame is
               formed here by f32 subtraction.
      radii:   tuple of 1..4 radii.
      precision: "highest" (one f32 ``matmul``) or "bf16x2" (the
               candidates' terms split into bf16 hi + mid + lo, three
               exact-product ``matmul``s summed in that order).
      with_sazo: also fold the signed z offset ``-dz = s_z - q_z`` of
               the candidates inside each radius into rows 10 (max,
               ``-BIG`` if none) and 11 (min, ``+BIG`` if none).
      n_attr:  0..6 attribute rows, summed under the mask into slab
               rows 10..10+n_attr (global values: no center is
               subtracted).
      metric:  "euclidean" (``dx*dx + dy*dy + dz*dz <= f32(r*r)``) or
               "chebyshev" (``max(|dx|, |dy|, |dz|) <= f32(r)``, the
               maximum propagating a NaN as ``jnp.maximum`` does).
      exclude_radius: euclidean only: keep only the pairs with
               ``d2 >= f32(e*e)`` (e*e in float64, as the reference),
               in every radius and in the sazo folds.

    Returns:
      (E, q_cap, len(radii) * 16) f32: per radius [count, sx, sy, sz,
      sxx, sxy, sxz, syy, syz, szz, 0 x 6] in the entry-local frame
      (rows 10 / 11 the sazo folds with ``with_sazo``, rows 10..10+A the
      attribute sums with ``n_attr``).
    """
    _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric)
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers, n_attr)
    n_r = len(radii)
    out = torch.zeros((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    limits = [torch.tensor(v, dtype=torch.float32, device=q_t.device)
              for v in _thresholds(radii, metric)]
    e2 = exclusion_threshold(exclude_radius)
    cand = cand_t.view(3 + n_attr, n_entries, c_cap)
    width = MOMENT_COLS + n_attr
    chunk = max(1, PAIR_BUDGET // max(q_cap * c_cap, 1))
    for s in range(0, n_entries, chunk):
        sl = slice(s, min(s + chunk, n_entries))
        c = centers[sl]
        q = q_t[sl] - c[:, :, None]                   # (e, 3, q_cap)
        x, y, z = cand[:3, sl] - c.T[:, :, None]      # (e, c_cap) each
        dx = q[:, 0, :, None] - x[:, None, :]         # (e, q_cap, c_cap)
        dy = q[:, 1, :, None] - y[:, None, :]
        dz = q[:, 2, :, None] - z[:, None, :]
        if metric == "chebyshev":
            dist = torch.maximum(torch.maximum(dx.abs(), dy.abs()),
                                 dz.abs())
        else:
            dist = dx * dx + dy * dy + dz * dz
        del dx, dy
        neg_dz = -dz if with_sazo else None
        del dz
        keep = None if e2 is None else dist >= e2
        aug = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                           x * z, y * y, y * z, z * z]
                          + list(cand[3:, sl].unbind(0)), dim=2)
        for ri in range(n_r):
            inside = dist <= limits[ri]
            if keep is not None:
                inside &= keep
            row = ri * MOMENT_PAD
            out[sl, :, row:row + width] = masked_sum(
                inside.to(torch.float32), aug, precision)
            if with_sazo:
                out[sl, :, row + 10] = torch.where(
                    inside, neg_dz, -BIG).amax(-1)
                out[sl, :, row + 11] = torch.where(
                    inside, neg_dz, BIG).amin(-1)
    return out


def moment_tolerance(slabs, cand_t, centers, n_attr=0):
    """Elementwise bound on |a - b| between two f32 evaluations of the
    same moment slabs that sum the candidates in different orders (see
    ``multiscale_kernel.slab_tolerance``); at most c_cap terms a sum.
    Attribute rows are bounded by each attribute's own extent over the
    entry's live candidates (global values)."""
    n_entries = centers.shape[0]
    c_cap = cand_t.shape[1] // n_entries
    cand = cand_t.view(3 + n_attr, n_entries, c_cap)
    live = cand[:3].abs().amax(0) < FAR / 2               # (E, c_cap)
    local = (cand[:3] - centers.T[:, :, None]).abs()
    extent = torch.where(live[None], local, 0.0).amax(dim=(0, 2))
    attr_extent = None
    if n_attr:
        attr_extent = torch.where(live[None], cand[3:].abs(),
                                  0.0).amax(dim=2).T     # (E, A)
    return slab_tolerance(slabs, extent, c_cap, attr_extent)


def live_lanes(cand_t):
    """The lanes of a packed candidate block (3 + A, E * c_cap) that hold
    a search point, not the FAR pad, as a device scalar: the one
    definition of a live lane (:func:`packed_moments_work`'s pairs, the
    serving step's ``lanes_live`` counter)."""
    return (cand_t[:3] != FAR).any(0).sum()


def packed_moments_work(q_t, cand_t, centers, radii, with_sazo=False,
                        n_attr=0, metric="euclidean", exclude_radius=None):
    """:func:`multiscale_kernel.moment_bound` of one call: live lanes
    (not the FAR sentinel) x q_cap pairs; bytes are the inputs read once
    and the slabs written once.  The distance term counts the
    instance's own formula: ``DISTANCE_OPS`` for the euclidean test,
    ``CHEBYSHEV_OPS`` for the max-norm one; ``with_sazo`` adds the
    fold's masked max and min, ``SAZO_OPS`` CUDA-core operations a pair
    and radius (the z difference is the distance's own);
    ``exclude_radius`` its compare and select, ``EXCLUSION_OPS`` a
    pair.  The tensor term sums 10 + ``n_attr`` columns."""
    n_entries, q_cap, _ = _shapes(q_t, cand_t, centers, n_attr)
    live = int(live_lanes(cand_t))
    n_bytes = 4 * (q_t.numel() + cand_t.numel() + centers.numel()) \
        + slab_bytes(n_entries, q_cap, len(radii))
    if metric == "chebyshev":
        ops = CHEBYSHEV_OPS
    else:
        ops = DISTANCE_OPS + (SAZO_OPS * len(radii) if with_sazo else 0)
        if exclude_radius is not None:
            ops += EXCLUSION_OPS
    return moment_bound(live * q_cap, len(radii), n_bytes,
                        distance_ops=ops, n_attr=n_attr)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.library("packed_moments").packed_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _attr_launcher():
    fn = cuda_build.library("packed_moments").packed_attr_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def packed_moments(q_t, cand_t, centers, radii, exclude_radius=None,
                   precision="highest", with_sazo=False, n_attr=0,
                   metric="euclidean"):
    """Raw masked moment slabs (see :func:`packed_moments_plain` for the
    arguments and layout).  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel -- its sazo instance with
    ``with_sazo``, an attribute instance with ``n_attr`` (the B operand
    widened to :func:`attr_slots` rows), a chebyshev instance (one
    radius, 1, 4 or 6 attribute rows) for ``metric="chebyshev"``, the
    exclusion instance of each euclidean family with
    ``exclude_radius`` -- or raise.  Both precisions launch the same
    kernel: its tensor-core sums take the bf16x2 split, whose exact
    products make it an f32 sum in another order."""
    _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric)
    if q_t.device.type == "cpu":
        return packed_moments_plain(q_t, cand_t, centers, radii,
                                    exclude_radius=exclude_radius,
                                    precision=precision,
                                    with_sazo=with_sazo, n_attr=n_attr,
                                    metric=metric)
    if q_t.device.type != "cuda":
        raise ValueError(f"unsupported device {q_t.device}")
    chebyshev = metric == "chebyshev"
    if chebyshev and len(radii) != 1:
        raise NotImplementedError(
            "the chebyshev kernel instances take one radius (the packed "
            "attribute interp's ball); the plain version takes more "
            "(ROADMAP.md Queue B, the chebyshev instances' radii)")
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers, n_attr)
    check_tensors(q_t.device, q_t=q_t, cand_t=cand_t, centers=centers)
    n_r = len(radii)
    out = torch.empty((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    if n_entries == 0:
        return out
    stream = torch.cuda.current_stream(q_t.device).cuda_stream
    device = q_t.device.index or 0
    pointers = (q_t.data_ptr(), cand_t.data_ptr(), centers.data_ptr(),
                out.data_ptr())
    excl = "" if exclude_radius is None else "excl_"
    if n_attr or chebyshev:
        limits = chebyshev_radii(radii) if chebyshev \
            else padded_radii(radii)
        check_launch("packed_moments", _attr_launcher()(
            *pointers, n_entries, q_cap, c_cap, n_r, n_attr, int(chebyshev),
            *exclusion_args(exclude_radius), *limits, device, stream))
        family = "interp_launches" if chebyshev else "attr_launches"
    else:
        check_launch("packed_moments", _launcher()(
            *pointers, n_entries, q_cap, c_cap, n_r, int(bool(with_sazo)),
            *exclusion_args(exclude_radius), *padded_radii(radii), device,
            stream))
        family = "sazo_launches" if with_sazo else "launches"
    family = excl + family
    setattr(packed_moments, family, getattr(packed_moments, family) + 1)
    return out


packed_moments.launches = 0
packed_moments.sazo_launches = 0
packed_moments.attr_launches = 0
packed_moments.interp_launches = 0
packed_moments.excl_launches = 0
packed_moments.excl_sazo_launches = 0
packed_moments.excl_attr_launches = 0
