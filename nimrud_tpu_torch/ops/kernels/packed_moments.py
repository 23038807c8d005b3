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

Ported: the euclidean metric without exclusion radius or attribute
rows, with or without the sazo rows (``with_sazo``: slab rows 10 / 11
of each radius hold the masked max / min of the signed z offset
``s_z - q_z``, ``-BIG`` / ``+BIG`` where no candidate is inside), at
``precision="highest"`` or ``"bf16x2"`` (the plain version sums bf16 hi
+ mid + lo parts as the reference does; the kernel computes that split
for both precisions).  ``exclude_radius``, attribute rows and the
chebyshev metric raise ``NotImplementedError`` in both versions
(ROADMAP.md Queue A #9).  ``packed_moments.launches`` counts launches of
the kernel without the sazo rows, ``packed_moments.sazo_launches`` those
of its sazo instance.
"""

import ctypes
import functools

import torch

from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import (
    DISTANCE_OPS, MOMENT_PAD, PAIR_BUDGET, check_launch, check_precision,
    check_radii, check_tensors, masked_sum, moment_bound, padded_radii,
    slab_bytes, slab_tolerance, squared_radii)

LANES = 128            # c_cap granularity (the packing contract)
FAR = 1.0e6            # dead-slot sentinel: d2 >= 1e12 fails every
                       # radius, and 3 * FAR^2 stays finite in f32
BIG = 1.0e30           # identity of the sazo max / min folds
SAZO_OPS = 2           # CUDA-core operations of the sazo fold a pair and
                       # radius: a masked max and a masked min


def _check_variant(radii, exclude_radius, precision, n_attr, metric):
    if exclude_radius is not None or n_attr or metric != "euclidean":
        raise NotImplementedError(
            "packed_moments is ported for the euclidean metric without "
            "exclude_radius or attributes (with or without sazo rows); see "
            "ROADMAP.md Queue A #9")
    check_precision(precision)
    check_radii(radii)


def _shapes(q_t, cand_t, centers):
    if q_t.dim() != 3 or q_t.shape[1] != 3:
        raise ValueError(f"q_t must be (E, 3, q_cap), got {tuple(q_t.shape)}")
    n_entries, _, q_cap = q_t.shape
    if cand_t.dim() != 2 or cand_t.shape[0] != 3:
        raise ValueError("cand_t must carry 3 rows (x, y, z)")
    if centers.shape != (n_entries, 3):
        raise ValueError("centers must be (E, 3)")
    c_cap = cand_t.shape[1] // max(n_entries, 1)
    if c_cap * n_entries != cand_t.shape[1]:
        raise ValueError("cand_t lane count must be E * c_cap")
    if c_cap % LANES:
        raise ValueError(f"c_cap must be a multiple of {LANES}")
    return n_entries, q_cap, c_cap


def packed_moments_plain(q_t, cand_t, centers, radii, exclude_radius=None,
                         precision="highest", with_sazo=False, n_attr=0,
                         metric="euclidean"):
    """
    Raw masked moment slabs, plain PyTorch.

    Args:
      q_t:     (E, 3, q_cap) f32 global-frame queries, coordinate axis
               second.
      cand_t:  (3, E * c_cap) f32 global-frame candidates (rows x, y,
               z); entry e owns lanes [e*c_cap, (e+1)*c_cap), dead
               slots hold FAR.  c_cap is a multiple of 128.
      centers: (E, 3) f32 entry centers; the entry-local frame is
               formed here by f32 subtraction.
      radii:   tuple of 1..4 radii.
      precision: "highest" (one f32 ``matmul``) or "bf16x2" (the
               candidates' terms split into bf16 hi + mid + lo, three
               exact-product ``matmul``s summed in that order).
      with_sazo: also fold the signed z offset ``-dz = s_z - q_z`` of
               the candidates inside each radius into rows 10 (max,
               ``-BIG`` if none) and 11 (min, ``+BIG`` if none).

    Returns:
      (E, q_cap, len(radii) * 16) f32: per radius [count, sx, sy, sz,
      sxx, sxy, sxz, syy, syz, szz, 0 x 6] in the entry-local frame
      (rows 10 / 11 the sazo folds with ``with_sazo``).
    """
    _check_variant(radii, exclude_radius, precision, n_attr, metric)
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers)
    n_r = len(radii)
    out = torch.zeros((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    r2 = [torch.tensor(float(v), dtype=torch.float32, device=q_t.device)
          for v in squared_radii(radii)]
    cand = cand_t.view(3, n_entries, c_cap)
    chunk = max(1, PAIR_BUDGET // max(q_cap * c_cap, 1))
    for s in range(0, n_entries, chunk):
        sl = slice(s, min(s + chunk, n_entries))
        c = centers[sl]
        q = q_t[sl] - c[:, :, None]                   # (e, 3, q_cap)
        x, y, z = cand[:, sl] - c.T[:, :, None]       # (e, c_cap) each
        dx = q[:, 0, :, None] - x[:, None, :]         # (e, q_cap, c_cap)
        dy = q[:, 1, :, None] - y[:, None, :]
        dz = q[:, 2, :, None] - z[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy
        neg_dz = -dz if with_sazo else None
        del dz
        aug = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                           x * z, y * y, y * z, z * z], dim=2)
        for ri in range(n_r):
            inside = d2 <= r2[ri]
            row = ri * MOMENT_PAD
            out[sl, :, row:row + 10] = masked_sum(
                inside.to(torch.float32), aug, precision)
            if with_sazo:
                out[sl, :, row + 10] = torch.where(
                    inside, neg_dz, -BIG).amax(-1)
                out[sl, :, row + 11] = torch.where(
                    inside, neg_dz, BIG).amin(-1)
    return out


def moment_tolerance(slabs, cand_t, centers):
    """Elementwise bound on |a - b| between two f32 evaluations of the
    same moment slabs that sum the candidates in different orders (see
    ``multiscale_kernel.slab_tolerance``); at most c_cap terms a sum."""
    n_entries = centers.shape[0]
    c_cap = cand_t.shape[1] // n_entries
    cand = cand_t.view(3, n_entries, c_cap)
    live = cand.abs().amax(0) < FAR / 2                   # (E, c_cap)
    local = (cand - centers.T[:, :, None]).abs()
    extent = torch.where(live[None], local, 0.0).amax(dim=(0, 2))
    return slab_tolerance(slabs, extent, c_cap)


def packed_moments_work(q_t, cand_t, centers, radii, with_sazo=False):
    """:func:`multiscale_kernel.moment_bound` of one call: live lanes
    (not the FAR sentinel) x q_cap pairs; bytes are the inputs read once
    and the slabs written once.  ``with_sazo`` adds the fold's masked
    max and min, ``SAZO_OPS`` CUDA-core operations a pair and radius, to
    the distance term (the z difference is the distance's own)."""
    n_entries, q_cap, _ = _shapes(q_t, cand_t, centers)
    live = int((cand_t != FAR).any(0).sum())
    n_bytes = 4 * (q_t.numel() + cand_t.numel() + centers.numel()) \
        + slab_bytes(n_entries, q_cap, len(radii))
    ops = DISTANCE_OPS + (SAZO_OPS * len(radii) if with_sazo else 0)
    return moment_bound(live * q_cap, len(radii), n_bytes,
                        distance_ops=ops)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.library("packed_moments").packed_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def packed_moments(q_t, cand_t, centers, radii, exclude_radius=None,
                   precision="highest", with_sazo=False, n_attr=0,
                   metric="euclidean"):
    """Raw masked moment slabs (see :func:`packed_moments_plain` for the
    arguments and layout).  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel (its sazo instance with
    ``with_sazo``), or raise.  Both precisions launch the same kernel:
    its tensor-core sums take the bf16x2 split, whose exact products
    make it an f32 sum in another order."""
    _check_variant(radii, exclude_radius, precision, n_attr, metric)
    if q_t.device.type == "cpu":
        return packed_moments_plain(q_t, cand_t, centers, radii,
                                    precision=precision,
                                    with_sazo=with_sazo)
    if q_t.device.type != "cuda":
        raise ValueError(f"unsupported device {q_t.device}")
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers)
    check_tensors(q_t.device, q_t=q_t, cand_t=cand_t, centers=centers)
    n_r = len(radii)
    out = torch.empty((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    if n_entries == 0:
        return out
    check_launch("packed_moments", _launcher()(
        q_t.data_ptr(), cand_t.data_ptr(), centers.data_ptr(),
        out.data_ptr(), n_entries, q_cap, c_cap, n_r, int(bool(with_sazo)),
        *padded_radii(radii), q_t.device.index or 0,
        torch.cuda.current_stream(q_t.device).cuda_stream))
    if with_sazo:
        packed_moments.sazo_launches += 1
    else:
        packed_moments.launches += 1
    return out


packed_moments.launches = 0
packed_moments.sazo_launches = 0
