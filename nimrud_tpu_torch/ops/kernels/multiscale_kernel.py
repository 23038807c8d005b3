"""
Masked moments over flat per-entry candidate blocks: the port of
``nimrud_tpu/ops/pallas/multiscale_kernel.py`` (``entry_moments``,
``moments_from_slabs``, ``MOMENT_PAD``), plus what the port's three
moment kernels share (squared radii, launch checks, the masked sum in
either precision, the f32 tolerance between two summation orders, and
the least time an H100 could take for a kernel's work).

``entry_moments`` has two versions with one signature and one layout:

* :func:`entry_moments_plain` -- plain PyTorch, looped over entry
  chunks.  It is the oracle: the CPU tests hold it against the JAX
  kernel, and ``chip_smoke.py`` holds the CUDA kernel against it.
* :func:`entry_moments` -- the wrapper of the hand-written Hopper
  kernel ``csrc/entry_moments.cu`` (it compacts each entry's valid
  candidates, then sums on the tensor cores through
  ``csrc/moment_mma.cuh``).  A CPU tensor goes to the plain version; a
  CUDA tensor launches the kernel or raises.  ``entry_moments.launches``
  counts kernel launches.

The expanded distance ``d2 = max((|q|^2 + |s|^2) - 2 q.s, 0)`` is this
kernel's contract (it decides the counts; ``grid._entry_stats`` uses the
difference form instead).  Both versions form it elementwise in one
fixed order, ``qq = (q0*q0 + q1*q1) + q2*q2`` (``ss`` alike) and
``qs = (q0*s0 + q1*s1) + q2*s2``, each operation rounded on its own, so
the kernel and the plain version give equal counts.  No matmul forms
``qs``: a library's summation order for K=3 is not fixed.  A NaN query
or candidate counts nowhere (``d2 <= r^2`` is false), as in the
reference.  ``exclude_radius`` keeps the pairs whose clamped ``d2`` is
at least ``f32(e*e)`` (:func:`exclusion_threshold`): the clamp matters
there, since a pair whose ``d2`` rounds below 0 passes ``e = 0`` only
clamped, and it propagates a NaN, so a NaN pair still fails.
"""

import ctypes
import functools

import numpy as np
import torch

from nimrud_tpu_torch.ops.kernels import cuda_build

MOMENT_PAD = 16         # 10 moment columns padded to 16 per radius
MAX_RADII = 4           # the CUDA kernels' template instances
PAIR_BUDGET = 1 << 25   # (query, candidate) pairs a plain twin forms per
                        # entry chunk
PRECISIONS = ("highest", "bf16x2")

# The H100 SXM rates a kernel's bound is reckoned against: the CUDA-core
# f32 rate at the 1.98 GHz boost clock (132 SMs x 128 lanes), the dense
# bf16 tensor-core peak and the HBM3 rate (NVIDIA's data sheet).
CUDA_CORE_OPS = 132 * 128 * 1.98e9
TENSOR_FLOPS = 989e12
HBM_BYTES = 3.35e12
DISTANCE_OPS = 8        # difference form: 3 sub, 3 mul, 2 add, none fused
EXCLUSION_OPS = 2       # exclude_radius: a compare and a select a pair
CLAMP_OPS = 1           # the expanded form's max(d2, 0) in that test
SPLIT_TERMS = 3         # bf16 hi + mid + lo of each moment term
MOMENT_COLS = 10        # count and the nine moment terms of a slab
MAX_ATTR = MOMENT_PAD - MOMENT_COLS   # attribute rows a slab can carry


def check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def bf16_split3(v):
    """f32 -> bf16 ``(hi, mid, lo)`` with ``hi + mid + lo == v`` exactly
    (each a round-to-nearest bf16 of what the terms before it left): the
    reference's ``precision="bf16x2"`` split."""
    hi = v.to(torch.bfloat16)
    rem = v - hi.to(torch.float32)
    mid = rem.to(torch.bfloat16)
    lo = (rem - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def masked_sum(mask, aug, precision):
    """``mask @ aug`` in f32.  With ``precision="bf16x2"`` ``aug`` is
    split into bf16 hi + mid + lo and the three products are summed in
    that order, as the reference does; the 0/1 mask is exact in bf16, so
    every product is exact and the counts stay exact."""
    if precision == "bf16x2":
        return sum(torch.matmul(mask, part.to(torch.float32))
                   for part in bf16_split3(aug))
    return torch.matmul(mask, aug)


def moment_bound(pairs, n_radii, n_bytes, distance_ops=DISTANCE_OPS,
                 n_attr=0):
    """The least time an H100 could take for a moment kernel's work, the
    largest of three terms: ``pairs`` distance tests of ``distance_ops``
    unfusable f32 operations on the CUDA cores; the masked sums, 10
    moments and ``n_attr`` attribute columns x 3 bf16 terms x 2 flops a
    pair and radius, on the tensor cores; ``n_bytes`` moved once through
    HBM.  Returns ``pairs``, ``terms_ms``, ``bound_ms`` and
    ``bound_term`` (the largest term)."""
    cols = MOMENT_COLS + n_attr
    terms = {"distance": pairs * distance_ops / CUDA_CORE_OPS,
             "tensor": pairs * n_radii * cols * SPLIT_TERMS * 2
             / TENSOR_FLOPS,
             "bytes": n_bytes / HBM_BYTES}
    term = max(terms, key=terms.get)
    return {"pairs": int(pairs),
            "terms_ms": {k: 1e3 * v for k, v in terms.items()},
            "bound_ms": 1e3 * terms[term], "bound_term": term}


def slab_bytes(n_entries, q_cap, n_radii):
    """Bytes of the f32 slabs a moment kernel writes."""
    return 4 * n_entries * q_cap * n_radii * MOMENT_PAD


def squared_radii(radii):
    """f32(r*r) with r*r in float64, exactly as the reference compares
    ``d2 <= radius * radius`` against a Python float."""
    return [np.float32(float(r) * float(r)) for r in radii]


def exclusion_threshold(exclude_radius):
    """f32(e*e) with e*e in float64, as the reference compares ``d2 >=
    exclude_radius * exclude_radius`` (:func:`squared_radii`); None
    without an exclusion."""
    if exclude_radius is None:
        return None
    return float(squared_radii([exclude_radius])[0])


def exclusion_args(exclude_radius):
    """The kernels' ``exclude, e2`` arguments."""
    e2 = exclusion_threshold(exclude_radius)
    return (0, 0.0) if e2 is None else (1, e2)


def padded_radii(radii):
    """The squared radii as the kernels' four float arguments."""
    r2 = [float(v) for v in squared_radii(radii)]
    return r2 + [0.0] * (MAX_RADII - len(r2))


def chebyshev_radii(radii):
    """The radii as the kernels' four float arguments for the chebyshev
    metric: ``f32(r)``, not squared, since the max-norm test is
    ``max(|dx|, |dy|, |dz|) <= r`` (the reference compares against the
    Python float ``radius``, which becomes an f32)."""
    r = [float(np.float32(float(v))) for v in radii]
    return r + [0.0] * (MAX_RADII - len(r))


def check_radii(radii):
    if not 1 <= len(radii) <= MAX_RADII:
        raise ValueError(f"1..{MAX_RADII} radii supported, got {radii}")


def check_tensors(device, dtype=torch.float32, **named):
    """Raise unless each tensor lies on ``device``, has ``dtype`` and is
    contiguous (what a kernel reading raw pointers needs)."""
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_launch(name, err):
    """Raise on a launcher's nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def slab_tolerance(slabs, extent, n_terms, attr_extent=None):
    """Elementwise bound on |a - b| between two f32 evaluations of the
    same moment slabs that sum the same rounded terms in different
    orders.

    Each differs from the exact sum by at most (n_terms - 1) * 2^-24 *
    sum|term| (any summation order), and sum|term| <= count *
    max|term|, with max|term| = extent (first moments) or extent^2
    (second).  ``extent``: (E,) bound on |local coordinate| of the
    entry's live candidates.  ``attr_extent``: (E, A) bound on |value|
    of each attribute row of those candidates (global values, not
    local coordinates), for slab rows 10..10+A.  Counts get 0: they are
    exact."""
    zero = torch.zeros_like(extent)
    attrs = [] if attr_extent is None else list(attr_extent.unbind(-1))
    row = torch.stack([zero] + [extent] * 3 + [extent * extent] * 6 + attrs
                      + [zero] * (MAX_ATTR - len(attrs)), dim=-1)  # (E, 16)
    n_r = slabs.shape[2] // MOMENT_PAD
    counts = slabs[..., 0::MOMENT_PAD]                     # (E, q, n_r)
    bound = counts[..., None] * row[:, None, None, :]
    eps = 2.0 * max(n_terms - 1, 1) * 2.0 ** -24
    return (eps * bound).reshape(slabs.shape[0], slabs.shape[1],
                                 n_r * MOMENT_PAD)


# -- entry_moments ------------------------------------------------------------

def _check_entry(q_local, s_local, s_valid, radii):
    check_radii(radii)
    if q_local.dim() != 3 or q_local.shape[2] != 3:
        raise ValueError(f"q_local must be (E, Q, 3), got "
                         f"{tuple(q_local.shape)}")
    n_entries = q_local.shape[0]
    if s_local.dim() != 3 or s_local.shape[0] != n_entries \
            or s_local.shape[2] != 3:
        raise ValueError(f"s_local must be (E, F, 3), got "
                         f"{tuple(s_local.shape)}")
    if tuple(s_valid.shape) != tuple(s_local.shape[:2]):
        raise ValueError("s_valid must be (E, F)")
    if s_valid.dtype != torch.bool:
        raise TypeError(f"s_valid must be bool, got {s_valid.dtype}")
    return n_entries, q_local.shape[1], s_local.shape[1]


def _sum_sq(p):
    """(p0*p0 + p1*p1) + p2*p2 over the last axis, in that order."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) \
        + p[..., 2] * p[..., 2]


def entry_moments_plain(q_local, s_local, s_valid, radii,
                        exclude_radius=None):
    """
    Raw masked moments for a batch of entries, plain PyTorch.

    Args:
      q_local: (E, Q, 3) f32 queries, entry-local frame.
      s_local: (E, F, 3) f32 candidates, entry-local frame.
      s_valid: (E, F) bool candidate validity.
      radii:   tuple of 1..4 radii.
      exclude_radius: keep only the pairs with ``max(d2, 0) >=
               f32(e*e)`` (the reference's clamp, NaN-propagating:
               ``torch.clamp``; a NaN pair fails).

    Returns:
      (E, Q, len(radii) * 16) f32: per radius [count, sx, sy, sz, sxx,
      sxy, sxz, syy, syz, szz, 0 x 6]; invalid candidates add nothing.
    """
    n_entries, q_cap, flat = _check_entry(q_local, s_local, s_valid, radii)
    n_r = len(radii)
    out = torch.zeros((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_local.device)
    r2 = [torch.tensor(float(v), dtype=torch.float32, device=q_local.device)
          for v in squared_radii(radii)]
    e2 = exclusion_threshold(exclude_radius)
    ones = s_valid.to(torch.float32)
    x, y, z = s_local.unbind(-1)
    aug = torch.stack([ones, x, y, z, x * x, x * y, x * z, y * y, y * z,
                       z * z], dim=2) * ones[..., None]          # (E, F, 10)
    qq, ss = _sum_sq(q_local), _sum_sq(s_local)
    chunk = max(1, PAIR_BUDGET // max(q_cap * flat, 1))
    for s in range(0, n_entries, chunk):
        sl = slice(s, min(s + chunk, n_entries))
        q = q_local[sl, :, None, :]                        # (e, Q, 1, 3)
        c = s_local[sl, None, :, :]                        # (e, 1, F, 3)
        qs = (q[..., 0] * c[..., 0] + q[..., 1] * c[..., 1]) \
            + q[..., 2] * c[..., 2]                        # (e, Q, F)
        d2 = torch.clamp((qq[sl, :, None] + ss[sl, None, :]) - 2.0 * qs,
                         min=0.0)
        del qs
        keep = None if e2 is None else d2 >= e2
        for ri in range(n_r):
            inside = d2 <= r2[ri]
            if keep is not None:
                inside &= keep
            mask = inside.to(torch.float32)
            out[sl, :, ri * MOMENT_PAD:ri * MOMENT_PAD + 10] = \
                torch.matmul(mask, aug[sl])
    return out


def entry_tolerance(slabs, s_local, s_valid):
    """:func:`slab_tolerance` for entry slabs: F terms a sum."""
    extent = torch.where(s_valid[..., None], s_local.abs(), 0.0)
    return slab_tolerance(slabs, extent.amax(dim=(1, 2)), s_local.shape[1])


def entry_moments_work(q_local, s_local, s_valid, radii,
                       exclude_radius=None):
    """:func:`moment_bound` of one ``entry_moments`` call: valid
    candidates x Q pairs, each an expanded-form distance of 8 f32
    operations (``qs`` 5, ``qq + ss`` 1, ``2 qs`` 1, the difference 1;
    the clamp ``max(d2, 0)`` cannot change ``d2 <= r^2`` for
    ``r^2 >= 0``, so the test needs none); ``exclude_radius`` adds the
    exclusion test's compare and select and its clamp, 3 more."""
    n_entries, q_cap = q_local.shape[:2]
    n_bytes = (4 * (q_local.numel() + s_local.numel()) + s_valid.numel()
               + slab_bytes(n_entries, q_cap, len(radii)))
    ops = DISTANCE_OPS
    if exclude_radius is not None:
        ops += EXCLUSION_OPS + CLAMP_OPS
    return moment_bound(int(s_valid.sum()) * q_cap, len(radii), n_bytes,
                        distance_ops=ops)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.library("entry_moments").entry_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def entry_moments(q_local, s_local, s_valid, radii, exclude_radius=None):
    """Raw masked moments (see :func:`entry_moments_plain` for the
    arguments and layout).  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel (its exclusion instance with
    ``exclude_radius``, counted in ``entry_moments.excl_launches``), or
    raise."""
    n_entries, q_cap, flat = _check_entry(q_local, s_local, s_valid, radii)
    device = q_local.device
    if device.type == "cpu":
        return entry_moments_plain(q_local, s_local, s_valid, radii,
                                   exclude_radius)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    check_tensors(device, q_local=q_local, s_local=s_local)
    check_tensors(device, torch.bool, s_valid=s_valid)
    out = torch.empty((n_entries, q_cap, len(radii) * MOMENT_PAD),
                      dtype=torch.float32, device=device)
    if n_entries == 0 or q_cap == 0:
        return out
    check_launch("entry_moments", _launcher()(
        q_local.data_ptr(), s_local.data_ptr(), s_valid.data_ptr(),
        out.data_ptr(), n_entries, q_cap, flat, len(radii),
        *exclusion_args(exclude_radius), *padded_radii(radii),
        device.index or 0, torch.cuda.current_stream(device).cuda_stream))
    if exclude_radius is None:
        entry_moments.launches += 1
    else:
        entry_moments.excl_launches += 1
    return out


entry_moments.launches = 0
entry_moments.excl_launches = 0


def moments_from_slabs(slabs, centers, radii, with_sazo=False, n_attr=0):
    """
    Raw moment slabs (E, Q, n_r * MOMENT_PAD) -> per-radius
    ``{"count", "mean_local", "mean", "cov"}`` statistics for the
    feature layouts.  ``centers``: (E, 3) entry centers restoring the
    global frame.  ``with_sazo`` also resolves the masked max / min of
    the signed z offset that ``packed_moments(with_sazo=True)`` writes
    into slab rows 10 / 11 to ``"sazo"``: the extreme of larger
    magnitude (the maximum on a tie ``hi == -lo``), 0 for an empty
    neighborhood.  ``n_attr`` reads the attribute sums that
    ``packed_moments(n_attr=A)`` writes into slab rows 10..10+A as
    ``"attr_mean"`` (E, Q, A): sum / max(count, 1), the V_MSO mean.
    """
    out = []
    for ri, _ in enumerate(radii):
        slab = slabs[:, :, ri * MOMENT_PAD:(ri + 1) * MOMENT_PAD]
        count = slab[..., 0]
        denom = torch.clamp(count, min=1.0)[..., None]
        mean_local = slab[..., 1:4] / denom
        mx, my, mz = mean_local.unbind(-1)
        outer = torch.stack(
            [mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz], dim=-1)
        out.append({
            "count": count,
            "mean_local": mean_local,
            "mean": mean_local + centers[:, None, :],
            "cov": slab[..., 4:10] / denom - outer,
        })
        if with_sazo:
            hi, lo = slab[..., 10], slab[..., 11]
            out[-1]["sazo"] = torch.where(
                count > 0, torch.where(hi >= -lo, hi, lo),
                torch.zeros_like(hi))
        if n_attr:
            out[-1]["attr_mean"] = slab[..., 10:10 + n_attr] / denom
    return out
