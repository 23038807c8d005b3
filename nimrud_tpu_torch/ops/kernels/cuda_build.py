"""
The one nvcc build of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a plain C library (no PyTorch headers),
compiled for sm_90a into ``_build/<name>-<hash>.so`` at first use and
loaded through ctypes.  The hash covers the source and the flags, so an
edited kernel rebuilds and an unchanged one is reused.  Every build
keeps what ``-Xptxas -v`` printed (registers, shared memory, spills)
beside the library.  A failed build raises with nvcc's stderr.

:func:`build_all` starts one nvcc per source at once and waits for all.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("packed_moments", "span_moments", "entry_moments")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the kernels in csrc/")


def _paths(name):
    """(source, library, ptxas report) paths of one kernel."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as handle:
        digest = hashlib.sha256(
            handle.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    return src, lib, lib[:-3] + ".ptxas.txt"


def _start(name):
    """Start nvcc for one kernel unless a build of this exact source
    exists.  Returns a finisher giving ``(library path, ptxas report)``."""
    src, lib, log = _paths(name)
    if os.path.exists(lib) and os.path.exists(log):
        def cached():
            with open(log) as handle:
                return lib, handle.read()
        return cached
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def finish():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n{err}")
        with open(log, "w") as handle:
            handle.write(err + out)
        os.replace(tmp, lib)
        return lib, err + out
    return finish


def build(name):
    """Build one kernel.  Returns ``(library path, ptxas report)``."""
    return _start(name)()


def build_all(names=KERNELS):
    """Build every kernel, all nvcc processes running together.
    Returns ``{name: (library path, ptxas report)}``."""
    finishers = {name: _start(name) for name in names}
    built, failed = {}, []
    for name, finish in finishers.items():   # wait for every nvcc
        try:
            built[name] = finish()
        except RuntimeError as err:
            failed.append(str(err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def library(name):
    """The loaded library of one kernel (built first if needed)."""
    path, _ = build(name)
    return ctypes.CDLL(path)


def ptxas_usage(report):
    """The lines of a ptxas report that give registers, shared memory
    and spills."""
    return [ln.split("info    :")[-1].strip() for ln in report.splitlines()
            if "Used" in ln or "spill" in ln]
