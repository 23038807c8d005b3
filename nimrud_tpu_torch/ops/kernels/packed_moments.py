"""
Masked moment slabs over dense packed candidate blocks: the port of the
TPU kernel ``nimrud_tpu/ops/pallas/packed_kernel.py:packed_moments``.

Two versions with one signature and one output layout:

* :func:`packed_moments_plain` -- plain PyTorch (broadcast distances and
  a masked ``matmul``), looped over entry chunks so a full band fits on
  the card.  It is the oracle: the CPU tests hold it against the JAX
  kernel, and ``chip_smoke.py`` holds the CUDA kernel against it.
* :func:`packed_moments` -- the wrapper of the hand-written Hopper
  kernel ``csrc/packed_moments.cu`` (design notes at its top).  A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernel
  or raises.  ``packed_moments.launches`` counts kernel launches.

The kernel is built with nvcc at first use into ``_build/`` (keyed by a
hash of the source) and loaded through ctypes.

Only the serving path's variant is ported: euclidean metric, no
exclusion radius, no sazo rows, no attribute rows, full f32.  The
others raise ``NotImplementedError`` in both versions (ROADMAP.md).
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MOMENT_PAD

LANES = 128            # c_cap granularity (the packing contract)
MAX_RADII = 4          # the kernel's template instances
FAR = 1.0e6            # dead-slot sentinel: d2 >= 1e12 fails every
                       # radius, and 3 * FAR^2 stays finite in f32

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_PKG, "csrc", "packed_moments.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric):
    if exclude_radius is not None or with_sazo or n_attr \
            or metric != "euclidean" or precision != "highest":
        raise NotImplementedError(
            "packed_moments is ported for the serving variant only "
            "(euclidean, no exclude_radius, no sazo, no attributes, "
            "precision='highest'); see ROADMAP.md Queue B #1")
    if not 1 <= len(radii) <= MAX_RADII:
        raise ValueError(f"1..{MAX_RADII} radii supported, got {radii}")


def _squared_radii(radii):
    """f32(r*r) with r*r in float64, exactly as the reference compares
    ``d2 <= radius * radius`` against a Python float."""
    return [np.float32(float(r) * float(r)) for r in radii]


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
                         metric="euclidean", pair_budget=1 << 25):
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

    Returns:
      (E, q_cap, len(radii) * 16) f32: per radius [count, sx, sy, sz,
      sxx, sxy, sxz, syy, syz, szz, 0 x 6] in the entry-local frame.
    """
    _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric)
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers)
    n_r = len(radii)
    out = torch.zeros((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    r2 = [torch.tensor(float(v), dtype=torch.float32, device=q_t.device)
          for v in _squared_radii(radii)]
    cand = cand_t.view(3, n_entries, c_cap)
    chunk = max(1, pair_budget // max(q_cap * c_cap, 1))
    for s in range(0, n_entries, chunk):
        sl = slice(s, min(s + chunk, n_entries))
        c = centers[sl]
        q = q_t[sl] - c[:, :, None]                   # (e, 3, q_cap)
        x, y, z = cand[:, sl] - c.T[:, :, None]       # (e, c_cap) each
        dx = q[:, 0, :, None] - x[:, None, :]         # (e, q_cap, c_cap)
        dy = q[:, 1, :, None] - y[:, None, :]
        dz = q[:, 2, :, None] - z[:, None, :]
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        aug = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                           x * z, y * y, y * z, z * z], dim=2)
        for ri in range(n_r):
            mask = (d2 <= r2[ri]).to(torch.float32)
            out[sl, :, ri * MOMENT_PAD:ri * MOMENT_PAD + 10] = \
                torch.matmul(mask, aug)
    return out


def moment_tolerance(slabs, cand_t, centers):
    """Elementwise bound on |a - b| between two f32 evaluations of the
    same moment slabs that sum the candidates in different orders.

    Both sum the same rounded terms, so each differs from the exact sum
    by at most (c_cap - 1) * 2^-24 * sum|term| (recursive summation),
    and sum|term| <= count * max|term|.  Counts get 0: they are exact."""
    n_entries = centers.shape[0]
    c_cap = cand_t.shape[1] // n_entries
    cand = cand_t.view(3, n_entries, c_cap)
    live = cand.abs().amax(0) < FAR / 2                   # (E, c_cap)
    local = (cand - centers.T[:, :, None]).abs()
    b1 = torch.where(live[None], local, 0.0).amax(dim=(0, 2))    # (E,)
    zero = torch.zeros_like(b1)
    row = torch.stack([zero] + [b1] * 3 + [b1 * b1] * 6
                      + [zero] * (MOMENT_PAD - 10), dim=-1)      # (E, 16)
    n_r = slabs.shape[2] // MOMENT_PAD
    counts = slabs[..., 0::MOMENT_PAD]                     # (E, q, n_r)
    bound = counts[..., None] * row[:, None, None, :]
    eps = 2.0 * max(c_cap - 1, 1) * 2.0 ** -24
    return (eps * bound).reshape(slabs.shape[0], slabs.shape[1],
                                 n_r * MOMENT_PAD)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build csrc/packed_moments.cu")


def build():
    """Compile the kernel for sm_90a unless a build of this exact
    source exists.  Returns ``(library path, ptxas report)``; the report
    is what ``-Xptxas -v`` printed (registers, shared memory, spills)
    when the library was built.  Raises with nvcc's stderr on failure."""
    with open(_SRC, "rb") as handle:
        digest = hashlib.sha256(
            handle.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"packed_moments-{digest}.so")
    log = lib[:-3] + ".ptxas.txt"
    if os.path.exists(lib) and os.path.exists(log):
        with open(log) as handle:
            return lib, handle.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SRC}:\n"
            f"{proc.stderr}")
    with open(log, "w") as handle:
        handle.write(proc.stderr + proc.stdout)
    os.replace(tmp, lib)
    return lib, proc.stderr + proc.stdout


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build()
    library = ctypes.CDLL(path)
    fn = library.packed_moments_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
    return library


def packed_moments(q_t, cand_t, centers, radii, exclude_radius=None,
                   precision="highest", with_sazo=False, n_attr=0,
                   metric="euclidean"):
    """Raw masked moment slabs (see :func:`packed_moments_plain` for the
    arguments and layout).  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel, or raise."""
    _check_variant(radii, exclude_radius, precision, with_sazo, n_attr,
                   metric)
    if q_t.device.type == "cpu":
        return packed_moments_plain(q_t, cand_t, centers, radii)
    if q_t.device.type != "cuda":
        raise ValueError(f"unsupported device {q_t.device}")
    n_entries, q_cap, c_cap = _shapes(q_t, cand_t, centers)
    for name, t in (("q_t", q_t), ("cand_t", cand_t), ("centers", centers)):
        if t.device != q_t.device:
            raise ValueError(f"{name} is on {t.device}, q_t on {q_t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_r = len(radii)
    out = torch.empty((n_entries, q_cap, n_r * MOMENT_PAD),
                      dtype=torch.float32, device=q_t.device)
    if n_entries == 0:
        return out
    r2 = [float(v) for v in _squared_radii(radii)]
    r2 += [0.0] * (MAX_RADII - n_r)
    stream = torch.cuda.current_stream(q_t.device).cuda_stream
    err = _library().packed_moments_launch(
        q_t.data_ptr(), cand_t.data_ptr(), centers.data_ptr(),
        out.data_ptr(), n_entries, q_cap, c_cap, n_r, *r2,
        q_t.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"packed_moments kernel launch failed: CUDA "
                           f"error {err}")
    packed_moments.launches += 1
    return out


packed_moments.launches = 0
