"""
Masked moment slabs over candidate spans of the tile-sorted cloud: the
port of the TPU kernel ``nimrud_tpu/ops/pallas/gather_kernel.py:
span_moments``.

Each entry owns ``n_span`` spans, contiguous row ranges ``[start, start
+ len)`` of the search cloud sorted by fine tile id (one per candidate
x-row of its box).  Every live row of a span counts (no per-tile cap);
spans of length 0 add nothing.  Distances come from entry-local f32
coordinates, ``x = s - c`` and the caller's ``q_local = q - c``, as
``dx*dx + dy*dy + dz*dz``, compared with ``f32(r*r)``.

Two versions with one signature and one output layout (that of
``multiscale_kernel.moments_from_slabs``):

* :func:`span_moments_plain` -- plain PyTorch.  It packs each entry's
  live span rows densely (chunked over entries) and runs broadcast
  distances and a masked ``matmul``.  It is the oracle: the CPU tests
  hold it against the JAX kernel, and ``chip_smoke.py`` holds the CUDA
  kernel against it.
* :func:`span_moments` -- the wrapper of the hand-written Hopper kernel
  ``csrc/span_moments.cu`` (its masked sums on the tensor cores,
  ``csrc/moment_mma.cuh``).  A CPU tensor goes to the plain version; a
  CUDA tensor launches the kernel or raises.  ``span_moments.launches``
  counts kernel launches.

``precision`` is "highest" or "bf16x2" (the reference's bf16 hi + mid +
lo split, in the plain version as the reference sums it; the kernel
computes that split for both).  Not ported (TPU-only): the lanes-major
``(4, n_pad)`` cloud and its 128-lane window alignment, the DMA ring,
the per-step live-span compaction, ``entries_per_step``, the resident
and debug modes.  ``exclude_radius`` keeps only the pairs with
``d2 >= f32(e*e)``, in both versions (the kernel's exclusion instance,
counted in ``span_moments.excl_launches``).
"""

import ctypes
import functools

import torch

from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import (
    DISTANCE_OPS, EXCLUSION_OPS, MOMENT_PAD, PAIR_BUDGET, check_launch,
    check_precision, check_radii, check_tensors, exclusion_args,
    exclusion_threshold, masked_sum, moment_bound, padded_radii, slab_bytes,
    slab_tolerance, squared_radii)

MAX_SPANS = 256        # spans per entry the CUDA kernel takes ((m+2)^2)


def _check(q_local, centers, span_starts, span_lens, sorted_pts, radii,
           precision):
    check_precision(precision)
    check_radii(radii)
    if q_local.dim() != 3 or q_local.shape[2] != 3:
        raise ValueError(f"q_local must be (E, q_cap, 3), got "
                         f"{tuple(q_local.shape)}")
    n_entries, q_cap, _ = q_local.shape
    if tuple(centers.shape) != (n_entries, 3):
        raise ValueError("centers must be (E, 3)")
    if span_starts.dim() != 2 or span_starts.shape[0] != n_entries \
            or span_lens.shape != span_starts.shape:
        raise ValueError("span_starts and span_lens must both be "
                         "(E, n_span)")
    for name, t in (("span_starts", span_starts), ("span_lens", span_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if sorted_pts.dim() != 2 or sorted_pts.shape[1] != 3:
        raise ValueError("sorted_pts must be (n, 3)")
    return n_entries, q_cap, span_starts.shape[1]


def _span_rows_of(span_starts, span_lens, span_rows, n_pts, entries):
    """Densely packed live span rows of a slice of entries: source row
    per slot (E', cap) and slot validity.  Slot j of an entry belongs to
    the last span whose exclusive-scan offset is <= j."""
    lens = torch.clamp(span_lens[entries].to(torch.int64), 0, span_rows)
    starts = span_starts[entries].to(torch.int64)
    off = torch.cumsum(lens, 1) - lens
    total = off[:, -1] + lens[:, -1]
    cap = max(int(total.max()) if total.numel() else 0, 1)
    j = torch.arange(cap, dtype=torch.int64, device=lens.device)
    j = j.expand(lens.shape[0], cap).contiguous()
    span = torch.clamp(
        torch.searchsorted(off.contiguous(), j, right=True) - 1, min=0)
    src = j + torch.gather(starts - off, 1, span)
    valid = j < total[:, None]
    return torch.clamp(src, 0, max(n_pts - 1, 0)), valid


def _entry_chunks(n_entries, q_cap, span_lens, span_rows):
    """Entry slices whose packed pair count stays within the budget."""
    total = torch.clamp(span_lens.to(torch.int64), 0, span_rows).sum(1)
    cap = max(int(total.max()) if total.numel() else 0, 1)
    chunk = max(1, PAIR_BUDGET // max(q_cap * cap, 1))
    return [slice(s, min(s + chunk, n_entries))
            for s in range(0, n_entries, chunk)]


def span_moments_plain(q_local, centers, span_starts, span_lens, sorted_pts,
                       radii, span_rows, exclude_radius=None,
                       precision="highest"):
    """
    Raw masked moment slabs over candidate spans, plain PyTorch.

    Args:
      q_local:     (E, q_cap, 3) f32 entry-local queries.
      centers:     (E, 3) f32 entry centers (global frame).
      span_starts: (E, n_span) int32 first row of each span in
                   ``sorted_pts``.
      span_lens:   (E, n_span) int32 live rows per span, clamped to
                   [0, span_rows].
      sorted_pts:  (n, 3) f32 global-frame search points sorted by fine
                   tile id.
      radii:       tuple of 1..4 radii.
      span_rows:   most live rows a span may hold.
      exclude_radius: keep only the pairs with ``d2 >= f32(e*e)``.
      precision:   "highest" (one f32 ``matmul``) or "bf16x2" (the rows'
                   terms split into bf16 hi + mid + lo, three
                   exact-product ``matmul``s summed in that order).

    Returns:
      (E, q_cap, len(radii) * 16) f32: per radius [count, sx, sy, sz,
      sxx, sxy, sxz, syy, syz, szz, 0 x 6] in the entry-local frame.
    """
    n_entries, q_cap, _ = _check(q_local, centers, span_starts, span_lens,
                                 sorted_pts, radii, precision)
    n_r = len(radii)
    dev = q_local.device
    out = torch.zeros((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=dev)
    r2 = [torch.tensor(float(v), dtype=torch.float32, device=dev)
          for v in squared_radii(radii)]
    e2 = exclusion_threshold(exclude_radius)
    for sl in _entry_chunks(n_entries, q_cap, span_lens, span_rows):
        src, valid = _span_rows_of(span_starts, span_lens, span_rows,
                                   sorted_pts.shape[0], sl)
        x, y, z = (sorted_pts[src] - centers[sl, None, :]).unbind(-1)
        q = q_local[sl]
        dx = q[:, :, 0, None] - x[:, None, :]         # (e, q_cap, cap)
        dy = q[:, :, 1, None] - y[:, None, :]
        dz = q[:, :, 2, None] - z[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        keep = valid[:, None, :]
        if e2 is not None:
            keep = keep & (d2 >= e2)
        aug = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                           x * z, y * y, y * z, z * z], dim=2)
        for ri in range(n_r):
            mask = ((d2 <= r2[ri]) & keep).to(torch.float32)
            out[sl, :, ri * MOMENT_PAD:ri * MOMENT_PAD + 10] = \
                masked_sum(mask, aug, precision)
    return out


def span_tolerance(slabs, centers, span_starts, span_lens, sorted_pts,
                   span_rows):
    """:func:`multiscale_kernel.slab_tolerance` for span slabs: as many
    terms a sum as the longest packed entry, extent the entry's largest
    |local coordinate| over its live rows."""
    n_entries, q_cap = slabs.shape[:2]
    extent = torch.zeros(n_entries, dtype=torch.float32,
                         device=slabs.device)
    for sl in _entry_chunks(n_entries, 1, span_lens, span_rows):
        src, valid = _span_rows_of(span_starts, span_lens, span_rows,
                                   sorted_pts.shape[0], sl)
        local = (sorted_pts[src] - centers[sl, None, :]).abs().amax(-1)
        extent[sl] = torch.where(valid, local, 0.0).amax(1)
    total = torch.clamp(span_lens.to(torch.int64), 0, span_rows).sum(1)
    n_terms = int(total.max()) if total.numel() else 1
    return slab_tolerance(slabs, extent, n_terms)


def span_moments_work(q_local, centers, span_starts, span_lens, sorted_pts,
                      radii, span_rows, exclude_radius=None):
    """:func:`multiscale_kernel.moment_bound` of one call: live span rows
    x q_cap pairs; bytes are the queries, centers and span tables read
    once, each live row's 3 coordinates read once and the slabs written
    once; ``exclude_radius`` adds its compare and select to each pair's
    distance operations."""
    n_entries, q_cap = q_local.shape[:2]
    live = int(torch.clamp(span_lens.to(torch.int64), 0, span_rows).sum())
    n_bytes = 4 * (q_local.numel() + centers.numel() + span_starts.numel()
                   + span_lens.numel() + 3 * live) \
        + slab_bytes(n_entries, q_cap, len(radii))
    ops = DISTANCE_OPS + (0 if exclude_radius is None else EXCLUSION_OPS)
    return moment_bound(live * q_cap, len(radii), n_bytes,
                        distance_ops=ops)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.library("span_moments").span_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def span_moments(q_local, centers, span_starts, span_lens, sorted_pts, radii,
                 span_rows, exclude_radius=None, precision="highest"):
    """Raw masked moment slabs over candidate spans (see
    :func:`span_moments_plain` for the arguments and layout).  CPU
    tensors take the plain version; CUDA tensors launch the Hopper
    kernel (its exclusion instance with ``exclude_radius``), or raise.
    Both precisions launch the same kernel (see
    :func:`packed_moments.packed_moments`)."""
    n_entries, q_cap, n_span = _check(
        q_local, centers, span_starts, span_lens, sorted_pts, radii,
        precision)
    device = q_local.device
    if device.type == "cpu":
        return span_moments_plain(q_local, centers, span_starts, span_lens,
                                  sorted_pts, radii, span_rows,
                                  exclude_radius=exclude_radius,
                                  precision=precision)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not 1 <= n_span <= MAX_SPANS:
        raise ValueError(f"1..{MAX_SPANS} spans per entry supported, got "
                         f"{n_span}")
    check_tensors(device, q_local=q_local, centers=centers,
                  sorted_pts=sorted_pts)
    check_tensors(device, torch.int32, span_starts=span_starts,
                  span_lens=span_lens)
    out = torch.empty((n_entries, q_cap, len(radii) * MOMENT_PAD),
                      dtype=torch.float32, device=device)
    if n_entries == 0 or q_cap == 0:
        return out
    check_launch("span_moments", _launcher()(
        q_local.data_ptr(), centers.data_ptr(), span_starts.data_ptr(),
        span_lens.data_ptr(), sorted_pts.data_ptr(), out.data_ptr(),
        n_entries, q_cap, n_span, int(span_rows), sorted_pts.shape[0],
        len(radii), *exclusion_args(exclude_radius), *padded_radii(radii),
        device.index or 0, torch.cuda.current_stream(device).cuda_stream))
    if exclude_radius is None:
        span_moments.launches += 1
    else:
        span_moments.excl_launches += 1
    return out


span_moments.launches = 0
span_moments.excl_launches = 0
