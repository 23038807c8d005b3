"""
The port's C++ host runtime (port of ``nimrud_tpu/native``): spatial
binning, voxel dedup, uint16 quantization, bounds and ASCII parsing of
point clouds on the host, in ``csrc/tilesort.cpp``.

:func:`library` builds the source with ``g++ -O3 -pthread -shared
-fPIC`` at first use into ``_build/tilesort-<key>.so`` and loads it
through ctypes.  Its three parallel loops (the tables' two and the
quantization) run on threads of their own (one per CPU of the process's
affinity mask), not under OpenMP as the reference's tables do: in a
process that holds torch, torch's OpenMP runtime would serve them, and
small parallel regions waited for its pool.  The key covers the source,
the flags, the compiler's version and the machine
(``platform.machine()``): there is no ``-march=native``, so a library
built on one x86-64 host runs on another, and a build for another
compiler or architecture is never loaded.  ``-ffp-contract=off`` keeps
``a * b + c`` out of fused multiply-adds, which would round otherwise
than the NumPy twins.  A failed build raises with the compiler's stderr:
there is no silent fallback.

Every function takes ``impl``: ``"native"`` (the library; what the port
runs) or ``"numpy"``, its NumPy twin, which gives the same result bit for
bit and exists to be compared with (the tests, ``chip_smoke.py``).
"""

import ctypes
import functools
import os
import platform
import re
import subprocess
import threading

import numpy as np

from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.utils import profiling

CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-ffp-contract=off",
             "-shared", "-fPIC")
SOURCE = os.path.join(cuda_build.CSRC, "tilesort.cpp")
BUILD_DIR = cuda_build.BUILD_DIR
IMPLS = ("native", "numpy")

_I64 = ctypes.c_int64
_PF32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_PF64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_PI32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_PI64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_PU16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")

_lock = threading.Lock()


def _bind(library):
    library.tile_sort.restype = _I64
    library.tile_sort.argtypes = [
        _PF32, _I64, _PF64, ctypes.c_double, _PI64, _I64,
        _PI32, _PI32, _PI64]
    library.fill_table.restype = None
    library.fill_table.argtypes = [
        _PI32, _PI64, _PI64, _PI64, _I64, _I64, _PI32]
    library.mark_neighbors.restype = None
    library.mark_neighbors.argtypes = [_PI64, _I64, _PI64, _PI64, _I64, _PU8]
    library.neighbor_rows.restype = None
    library.neighbor_rows.argtypes = [
        _PI64, _I64, _PI64, _PI64, _I64, _PI32, ctypes.c_int32, _PI32]
    library.voxel_unique.restype = _I64
    library.voxel_unique.argtypes = [
        _PF32, _I64, _PF64, ctypes.c_double, _PI64, _PF32]
    library.quantize_u16.restype = _I64
    library.quantize_u16.argtypes = [
        _PF32, _I64, _I64, _PF64, ctypes.c_double, _PU16]
    library.minmax3.restype = None
    library.minmax3.argtypes = [_PF32, _I64, _PF32, _PF32]
    library.parse_ascii.restype = _I64
    library.parse_ascii.argtypes = [
        ctypes.c_char_p, _I64, _I64, _I64, _PF32]
    return library


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx):
    """The compiler's version line and the machine, for the build key."""
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True)
    except FileNotFoundError as err:
        raise RuntimeError(f"{cxx} not found: a C++ compiler is needed to "
                           f"build {SOURCE}") from err
    lines = (proc.stdout or proc.stderr).splitlines()
    return f"{lines[0] if lines else ''} {platform.machine()}"


def library_path(cxx=None, build_dir=None):
    """Where the library of this source, these flags and this compiler
    is (or would be) built."""
    cxx = cxx or CXX
    key = cuda_build.source_key(SOURCE, CXX_FLAGS, salt=_compiler_id(cxx))
    return os.path.join(build_dir or BUILD_DIR, f"tilesort-{key}.so")


@functools.lru_cache(maxsize=None)
def _load(cxx, build_dir):
    lib = library_path(cxx, build_dir)
    path, _ = cuda_build.start_compile([cxx, *CXX_FLAGS], SOURCE, lib)()
    return _bind(ctypes.CDLL(path))


def library():
    """The loaded host library, built first where this source, these
    flags and this compiler have no build yet.  Raises ``RuntimeError``
    with the compiler's stderr when the build fails."""
    with _lock:
        return _load(CXX, BUILD_DIR)


def _native(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "native"


def _points(points):
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (n, 3), got {points.shape}")
    return points


def _cells(points, lo, edge, dims):
    """Per-axis grid cells of float32 points, in float64, clipped into
    the grid: the arithmetic of every binning loop of the library."""
    return np.clip(np.floor((points.astype(np.float64) - lo) / edge)
                   .astype(np.int64), 0, dims - 1)


def _linear(cells, dims):
    return cells[:, 0] + cells[:, 1] * dims[0] + cells[:, 2] * (dims[0]
                                                                * dims[1])


# -- spatial binning ----------------------------------------------------------

def tile_sort(points, lo, edge, dims, factor, impl="native"):
    """Tile ids of (n, 3) points on the grid ``dims`` (edge ``edge``,
    origin ``lo``) coarsened ``factor`` times, and a stable counting
    sort by them.  Returns ``(ids int32, order int32, counts int64 per
    coarse tile)``, or None when the coarse grid exceeds int32 ids."""
    points = _points(points)
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    dims = np.ascontiguousarray(dims, dtype=np.int64)
    factor = int(factor)
    qdims = -(-dims // factor)
    grid = int(qdims.prod())
    if grid > np.iinfo(np.int32).max:
        return None
    n = points.shape[0]
    if not _native(impl):
        ids = _linear(_cells(points, lo, edge, dims) // factor, qdims)
        return (ids.astype(np.int32),
                np.argsort(ids, kind="stable").astype(np.int32),
                np.bincount(ids, minlength=grid).astype(np.int64))
    ids = np.empty(n, np.int32)
    order = np.empty(n, np.int32)
    counts = np.empty(grid, np.int64)
    library().tile_sort(points, n, lo, float(edge), dims, factor, ids,
                        order, counts)
    return ids, order, counts


def fill_table(order, starts_all, counts_all, wanted, cap, impl="native"):
    """A ``(len(wanted) + 1, cap)`` int32 table: row k holds
    ``order[starts_all[t] : starts_all[t] + min(counts_all[t], cap)]``
    for ``t = wanted[k]`` and -1 after it; the last row is all -1."""
    order = np.ascontiguousarray(order, dtype=np.int32)
    starts_all = np.ascontiguousarray(starts_all, dtype=np.int64)
    counts_all = np.ascontiguousarray(counts_all, dtype=np.int64)
    wanted = np.ascontiguousarray(wanted, dtype=np.int64)
    cap = int(cap)
    if len(wanted) and (wanted.min() < 0 or wanted.max() >= len(starts_all)
                        or len(counts_all) != len(starts_all)):
        raise ValueError("wanted rows outside the start / count tables")
    starts = starts_all[wanted]
    counts = np.minimum(counts_all[wanted], cap)
    if len(wanted) and (counts.min() < 0 or starts.min() < 0
                        or (starts + counts).max() > len(order)):
        raise ValueError("a table row reaches outside order")
    if not _native(impl):
        table = np.full((len(wanted) + 1, cap), -1, dtype=np.int32)
        row = np.repeat(np.arange(len(wanted)), counts)
        col = (np.arange(int(counts.sum()))
               - np.repeat(np.cumsum(counts) - counts, counts))
        table[row, col] = order[np.repeat(starts, counts) + col]
        return table
    table = np.empty((len(wanted) + 1, cap), np.int32)
    library().fill_table(order, starts_all, counts_all, wanted, len(wanted),
                         cap, table)
    return table


def neighbor_ids(tile_ids, dims, qdims, m):
    """Fine-grid ids of the (m+2)^3 tiles around each coarse tile (dx
    slowest, dz fastest), and whether each lies inside the grid."""
    base = np.stack([tile_ids % qdims[0], (tile_ids // qdims[0]) % qdims[1],
                     tile_ids // (qdims[0] * qdims[1])], axis=1) * m
    offsets = np.array([(dx, dy, dz) for dx in range(-1, m + 1)
                        for dy in range(-1, m + 1)
                        for dz in range(-1, m + 1)], dtype=np.int64)
    ncoord = base[:, None, :] + offsets[None, :, :]
    ok = np.all((ncoord >= 0) & (ncoord < dims), axis=2)
    return _linear(ncoord.reshape(-1, 3), dims).reshape(ok.shape), ok


def _tile_args(tile_ids, dims, qdims, m):
    tile_ids = np.ascontiguousarray(tile_ids, dtype=np.int64)
    dims = np.ascontiguousarray(dims, dtype=np.int64)
    qdims = np.ascontiguousarray(qdims, dtype=np.int64)
    if len(tile_ids) and (tile_ids.min() < 0
                          or tile_ids.max() >= int(qdims.prod())):
        raise ValueError("coarse tile ids outside the coarse grid")
    return tile_ids, dims, qdims, int(m)


def mark_neighbors(tile_ids, dims, qdims, m, n_grid, impl="native"):
    """Boolean (n_grid,) mask of every fine tile adjacent (offsets -1..m
    a side) to one of the coarse tiles ``tile_ids``."""
    tile_ids, dims, qdims, m = _tile_args(tile_ids, dims, qdims, m)
    if int(n_grid) != int(dims.prod()):
        raise ValueError("n_grid must be the fine grid's size")
    mask = np.zeros(int(n_grid), np.uint8)
    if not _native(impl):
        nid, ok = neighbor_ids(tile_ids, dims, qdims, m)
        mask[nid[ok]] = 1
    else:
        library().mark_neighbors(tile_ids, len(tile_ids), dims, qdims, m,
                                 mask)
    return mask.view(bool)


def neighbor_rows(tile_ids, dims, qdims, m, grid_row, empty_row,
                  impl="native"):
    """(len(tile_ids), (m+2)^3) int32: ``grid_row`` of each neighbor
    tile inside the grid, ``empty_row`` outside it."""
    tile_ids, dims, qdims, m = _tile_args(tile_ids, dims, qdims, m)
    grid_row = np.ascontiguousarray(grid_row, dtype=np.int32)
    if grid_row.shape != (int(dims.prod()),):
        raise ValueError("grid_row must hold one row per fine tile")
    if not _native(impl):
        nid, ok = neighbor_ids(tile_ids, dims, qdims, m)
        return np.where(ok, grid_row[np.where(ok, nid, 0)],
                        np.int32(empty_row)).astype(np.int32)
    out = np.empty((len(tile_ids), (m + 2) ** 3), np.int32)
    library().neighbor_rows(tile_ids, len(tile_ids), dims, qdims, m,
                            grid_row, np.int32(empty_row), out)
    return out


def voxel_unique(points, lo, edge, dims, impl="native"):
    """Float32 centers of the occupied cells of the grid ``dims`` (edge
    ``edge``, origin ``lo``), sorted by linear cell id."""
    points = _points(points)
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    dims = np.ascontiguousarray(dims, dtype=np.int64)
    if not _native(impl):
        keys = np.unique(_linear(_cells(points, lo, edge, dims), dims))
        cells = np.stack([keys % dims[0], (keys // dims[0]) % dims[1],
                          keys // (dims[0] * dims[1])], axis=1)
        return (lo[None, :] + (cells + 0.5) * edge).astype(np.float32)
    out = np.empty((points.shape[0], 3), np.float32)
    count = library().voxel_unique(points, points.shape[0], lo, float(edge),
                                   dims, out)
    return out[:count].copy()


# -- serving ------------------------------------------------------------------

def quantize_u16(points, lo, step, pad_to=None, impl="native"):
    """(n, 3) float32 points as uint16 grid steps: ``floor((p - lo) /
    step + 0.5)`` in float64 (ties round up), clipped to [0, 65535].
    ``pad_to`` pads the rows to that count by repeating the last one
    (zeros where there are no points).  The library writes the rows and
    the pad in one pass over the workers of its parallel loops, and
    counts them as ``quantize_workers`` (:func:`profiling.count`: only
    under a profiler session, inside a span)."""
    points = _points(points)
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    n = points.shape[0]
    rows = n if pad_to is None else int(pad_to)
    if rows < n:
        raise ValueError(f"pad_to {rows} is below the {n} points")
    out = np.empty((rows, 3), np.uint16)
    if not _native(impl):
        grid = (points.astype(np.float64) - lo) / float(step)
        out[:n] = np.clip(np.floor(grid + 0.5), 0, 65535)
        out[n:] = out[n - 1] if n else 0
        return out
    workers = library().quantize_u16(points, n, rows, lo, float(step), out)
    profiling.count("quantize_workers", workers)
    return out


def minmax3(points, impl="native"):
    """Per-axis (lo, hi) float32 bounds of (n, 3) points in one pass.
    An empty cloud has none: it raises ``ValueError``."""
    points = _points(points)
    if points.shape[0] == 0:
        raise ValueError("the bounds of an empty cloud are undefined")
    if not _native(impl):
        return points.min(0), points.max(0)
    lo = np.empty(3, np.float32)
    hi = np.empty(3, np.float32)
    library().minmax3(points, points.shape[0], lo, hi)
    return lo, hi


# -- ingest -------------------------------------------------------------------

_FIELDS = re.compile(rb"[,; \t]+")


def parse_ascii(text, impl="native"):
    """Delimited ASCII (bytes) -> float32 (rows, cols): fields split by
    commas, semicolons or whitespace, lines starting with ``#`` and blank
    lines skipped, ``cols`` the field count of the first data line (the
    fields past it on a longer line are ignored).  Raises ``ValueError``
    without a data line or on a field that is not a number.  The twin
    parses each field to float64 and rounds to float32, which equals the
    library's ``strtof`` for decimals of at most 8 fractional digits
    (their float64 cannot land on a float32 rounding midpoint); the
    library also reads on into the next line where a line holds fewer
    than ``cols`` fields, which the twin refuses."""
    text = bytes(text)
    first = next((s for s in (ln.strip() for ln in text.splitlines())
                  if s and not s.startswith(b"#")), None)
    if first is None:
        raise ValueError("no data rows")
    cols = len(first.replace(b",", b" ").replace(b";", b" ").split())
    if not _native(impl):
        rows = []
        for line in text.split(b"\n"):
            line = line.lstrip(b"\r")
            if not line or line.startswith(b"#"):
                continue
            fields = _FIELDS.split(line.strip())[:cols]
            if len(fields) < cols:
                raise ValueError(f"a line of fewer than {cols} fields")
            try:
                rows.append([float(f) for f in fields])
            except ValueError as err:
                raise ValueError(f"malformed field: {err}") from None
        return np.asarray(rows, dtype=np.float64).astype(np.float32)
    max_rows = text.count(b"\n") + 1
    out = np.empty((max_rows, cols), np.float32)
    rows = library().parse_ascii(text, len(text), cols, max_rows, out)
    if rows < 0:
        raise ValueError("malformed field")
    return out[:rows].copy()
