"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``.  The build
runs at first use, into ``build/kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists) or, for an installed package, into the
user's cache directory, under a name that hashes the sources and flags, so
an edited source is never served from a stale library.  Processes that
build at once take turns on a file lock, and each compiles in a private
temporary directory, so none can link another's half-written objects.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"


def _build_dir() -> Path:
    """``build/kernels/`` in the checkout that holds this package (``src/``
    layout beside ``pyproject.toml``); else ``repro_torch/kernels`` under
    the user's cache directory."""
    root = PACKAGE.parents[1]
    if PACKAGE.parent.name == "src" and (root / "pyproject.toml").exists():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "kernels"


BUILD_DIR = _build_dir()
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: every pointer and the stream are c_void_p (a bare int would
# be passed as 32 bits and cut the pointer)
SIGNATURES = {
    "sals_latent_topk": [_P, _P, _I, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sals_sparse_recon_attention": [
        _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "sals_latent_score": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "sals_latent_topk_paged": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    "sals_sparse_recon_attention_paged": [
        _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "sals_sparse_recon_attention_window": [
        _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "sals_sparse_recon_attention_window_paged": [
        _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
        _P],
    "sals_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into one shared library.  Returns its path; reuses a library
    whose hash matches."""
    global build_seconds
    out = BUILD_DIR / f"libsals_kernels_{_digest()}.so"
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when closed
        if out.exists():                        # built while we waited
            build_seconds = 0.0
            return out
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            t0 = time.perf_counter()
            _compile_and_link(work, out)
            build_seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def _compile_and_link(work: Path, out: Path) -> None:
    """nvcc each source into ``work``, link there, then move the library
    into place under its final name in one rename."""
    global build_log
    cus, _ = _sources()
    nvcc = _nvcc()
    objs, procs = [], []
    for cu in cus:
        obj = work / (cu.stem + ".o")
        objs.append(obj)
        procs.append((cu, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cu, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {cu.name}\n{text}")
        if p.returncode != 0:
            failed.append(cu.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    lib = work / out.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    os.replace(lib, out)
    (BUILD_DIR / "build.log").write_text(build_log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """Device address of ``t`` (NULL for None) as a C pointer argument."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def require(cond: bool, msg: str) -> None:
    """Reject an operand the kernel does not take."""
    if not cond:
        raise ValueError(msg)


class LaunchCounter:
    """A plain launch count: the wrapper adds one where it launches its
    kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0
