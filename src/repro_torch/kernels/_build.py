"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into an object, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources, the headers beside them
(``csrc/*.cuh``) and the compile and link flags, so an edited file is
rebuilt and an unchanged one is loaded as is.  Nothing is built
when the module is imported: the first call of :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]
# The library links no libcuda: cuTensorMapEncodeTiled (the flash kernel's
# TMA maps) is looked up through the CUDA runtime.
LINK_FLAGS = ["-shared", *ARCH_FLAGS]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ip = ctypes.POINTER(ctypes.c_int)
# C entry points and their argument types: a pointer must be c_void_p, or
# ctypes passes it as a 32-bit int and cuts it.
SIGNATURES = {
    "paged_attention_fwd": [_i, _vp, _vp, _vp, _vp, _vp, _vp,
                            _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _i, _i, _i, _i,
                            _vp, _vp, _vp],
    "rmsnorm_fwd": [_i, _i, _vp, _vp, _vp, _i, _i, _f, _ip, _vp],
    "empty_launch": [_vp],
    "flash_attention_fwd": [_i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _vp],
    "ssd_chunk_fwd": [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from src/repro_torch/kernels/csrc with the CUDA toolkit"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of every source and header under ``CSRC`` and of the compile
    and link flags: a change to any of them names a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(b"\0" + " ".join(LINK_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path (an existing library for the same sources is
    reused).  Raises ``RuntimeError`` with the compiler's output when a
    source does not compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{lib_path.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed, logs = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *LINK_FLAGS, *(str(o) for _, o, _ in procs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    if verbose:
        print("\n".join(logs))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def runs_plain(*tensors) -> bool:
    """Whether a wrapper takes its kernel's plain version: every operand on
    the CPU, or on the meta device, whose tensors hold no data (the dry
    run's shape-only trace, ``launch.cells.trace_cell``).  A CUDA operand
    launches the kernel."""
    return all(t.device.type in ("cpu", "meta") for t in tensors)


def count_launch(fn, path: Optional[str] = None) -> None:
    """Add one to a wrapper's ``launches`` (and to ``launches_by_path[path]``)
    under a lock.  Worker threads serving on one card at once launch
    through the same wrappers, and ``+=`` on an attribute is a read and a
    write that another thread may run between: unguarded, two leases'
    counts could lose launches."""
    with _count_lock:
        fn.launches += 1
        if path is not None:
            fn.launches_by_path[path] += 1


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
