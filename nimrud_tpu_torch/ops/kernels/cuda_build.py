"""
The one nvcc build of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a plain C library (no PyTorch headers),
compiled for sm_90a into ``_build/<name>-<hash>.so`` at first use and
loaded through ctypes.  The hash covers the source, every header of
its directory that it includes (``#include "x.cuh"``, followed
recursively) and the flags, so an edited kernel or header rebuilds and
an unchanged one is reused.  Every build
keeps what ``-Xptxas -v`` printed (registers, shared memory, spills)
beside the library.  A failed build raises with nvcc's stderr.

:func:`build_all` starts one nvcc per source at once and waits for all.
:func:`start_compile` is the build step shared with the port's C++ host
runtime (``ops/native.py``).
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("packed_moments", "span_moments", "entry_moments",
           "forest_walk")


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the kernels in csrc/")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_key(src, flags=NVCC_FLAGS, salt=""):
    """Hash of a source file, the local headers it includes (each once,
    recursively), the compiler flags and ``salt`` (anything else the
    library depends on, such as the compiler's version)."""
    digest = hashlib.sha256((" ".join(flags) + salt).encode())
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as handle:
            text = handle.read()
        digest.update(os.path.basename(path).encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text):
            header = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(header):
                todo.append(os.path.abspath(header))
    return digest.hexdigest()[:16]


def _paths(name):
    """(source, library, ptxas report) paths of one kernel."""
    src = os.path.join(CSRC, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"{name}-{source_key(src)}.so")
    return src, lib, lib[:-3] + ".ptxas.txt"


def start_compile(argv, src, lib, log=None):
    """Start ``argv -o <tmp> src`` unless ``lib`` (and ``log``, when
    given) exists.  The output goes to a file of this process and
    thread, renamed to ``lib`` once the compiler succeeds, so processes
    building at once never load a partial library.  Returns a finisher
    giving ``(lib, compiler output)``; it raises with the compiler's
    stderr when the build fails."""
    if os.path.exists(lib) and (log is None or os.path.exists(log)):
        def cached():
            if log is None:
                return lib, ""
            with open(log) as handle:
                return lib, handle.read()
        return cached
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen([*argv, "-o", tmp, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def finish():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(argv[0])} failed "
                               f"({proc.returncode}) building {src}:\n{err}")
        if log is not None:
            with open(log, "w") as handle:
                handle.write(err + out)
        os.replace(tmp, lib)
        return lib, err + out
    return finish


def _start(name):
    """Start nvcc for one kernel unless a build of this exact source
    exists.  Returns a finisher giving ``(library path, ptxas report)``."""
    src, lib, log = _paths(name)
    return start_compile([_nvcc(), *NVCC_FLAGS], src, lib, log)


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
    and spills, each led by its kernel's name (:func:`kernel_name`) where
    the report named the function first."""
    lines, name = [], None
    for ln in report.splitlines():
        found = _PTXAS_FUNCTION.search(ln)
        if found:
            name = kernel_name(found.group(1))
        elif "Used" in ln or "spill" in ln:
            text = ln.split("info    :")[-1].strip()
            lines.append(f"{name}: {text}" if name else text)
    return lines


def spill_bytes(report):
    """Bytes of spill stores plus spill loads over every function of a
    ptxas report."""
    return sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report))


_FUNCTION = re.compile(r"Function : (\S+)")
_PTXAS_FUNCTION = re.compile(r"Compiling entry function '([^']+)'")
_TEMPLATE = re.compile(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E")
_ARGUMENT = re.compile(r"L([ib])(\d+)E")
_PLAIN = re.compile(r"\d([a-z][a-z_]*_kernel)E")


def kernel_name(mangled):
    """A templated kernel's mangled name with its int and bool template
    arguments, as ``name<N>``, ``name<N, true|false>`` or ``name<N, M>``;
    a kernel without template arguments (in a namespace) as ``name``;
    other names unchanged."""
    template = _TEMPLATE.search(mangled)
    if not template:
        plain = _PLAIN.search(mangled)
        return plain.group(1) if plain else mangled
    kernel, args = template.groups()
    values = [value if kind == "i" else ("true" if value == "1" else "false")
              for kind, value in _ARGUMENT.findall(args)]
    return f"{kernel}<{', '.join(values)}>"


def count_sass(sass, opcode="HMMA"):
    """Instructions of ``opcode`` per kernel function in the text of
    ``cuobjdump -sass``, keyed by :func:`kernel_name`."""
    counts, name = {}, None
    for line in sass.splitlines():
        found = _FUNCTION.search(line)
        if found:
            name = kernel_name(found.group(1))
            counts[name] = 0
        elif name is not None and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


def sass(path):
    """The SASS of a built library (``cuobjdump -sass``, from nvcc's
    toolkit)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
