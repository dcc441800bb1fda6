"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
a stale library is never loaded.  Libraries go under
``build/repro_torch/`` at the repository root (``build/`` is ignored by
git); the compiler's report (registers, spills) sits beside each library
as ``<name>-<hash>.log``.  :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

Beside the build, what every wrapper shares: the storage types of the
kernels' C interfaces (:func:`storage_code`), the check of a C entry
point's return code (:func:`check`) and the launch and plain-call counts
(:func:`count`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME "
                       f"or /usr/local/cuda); cannot build {CSRC}")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        digest.update(hdr.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library is current; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return target, proc


def _finish(name: str, target: Path, proc) -> Path:
    if proc is None:
        return target
    rc = proc.wait()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if rc != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
                           + target.with_suffix(".log").read_text())
    os.replace(tmp, target)
    return target


def build_all() -> dict[str, Path]:
    """Compile every source that is not current, all in parallel."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, *started[name]) for name in started}


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Load (building first if needed) the library of ``csrc/<name>.cu``.

    Every source exports ``error_string(int)``, the text of a CUDA error
    code, beside its entry points."""
    target = _finish(name, *_start(name))
    lib = ctypes.CDLL(str(target))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, entry: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}: "
                           f"{lib.error_string(rc).decode()}")


_COUNT_LOCK = threading.Lock()


def count(fn, kind: str, dtype, pair: bool = False) -> None:
    """Add one to a wrapper's ``kind`` count ("launches" or
    "plain_calls"); a call on bf16 storage counts as ``<kind>_bf16``, so
    a run shows which instance it went through, and a launch of a Wilson
    kernel's bf16 pair instance (``pair``) in ``launches_bf16_pair`` too."""
    attr = kind + ("_bf16" if dtype == torch.bfloat16 else "")
    with _COUNT_LOCK:   # a server's worker thread launches too
        setattr(fn, attr, getattr(fn, attr) + 1)
        if pair:
            fn.launches_bf16_pair += 1


COUNTS = ("launches", "plain_calls", "launches_bf16", "plain_calls_bf16",
          "launches_bf16_pair")


def zero_counts(fn) -> None:
    """Set every count of a wrapper to 0."""
    for attr in COUNTS:
        setattr(fn, attr, 0)


# the kernels' storage types and their codes in the C interfaces
STORAGE = {torch.float32: 0, torch.bfloat16: 1}


def storage_code(entry: str, tensors) -> int:
    """The one storage dtype of a kernel call's operands, as its C code.

    float32 and bf16 are the kernels' storage types; float16 has no
    instance yet (ROADMAP Queue B item 9) and raises NotImplementedError,
    on the CPU too, so the plain versions keep the kernels' contract."""
    dtype = tensors[0].dtype
    for v in tensors:
        if v.dtype != dtype:
            raise ValueError(f"{entry}: operands must share one dtype, got "
                             f"{v.dtype} and {dtype}")
    if dtype not in STORAGE:
        raise NotImplementedError(
            f"{entry} stores float32 or bfloat16, got {dtype}; other narrow "
            "storage (float16) is ROADMAP Queue B item 9")
    return STORAGE[dtype]
