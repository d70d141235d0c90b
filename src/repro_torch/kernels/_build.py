"""Builds the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``. The file name carries a
hash of the source, every shared header ``csrc/*.cuh`` and the flags
(:func:`_digest`), so an edited kernel or header rebuilds and a stale library
is never picked up. Nothing is built at import time, and a build failure
raises with the compiler's output; it is never swallowed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "load_library", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# One lock per library: two sources build at once (each in its own nvcc
# process) when two threads ask for them, and one source is built once.
_LOCKS_LOCK = threading.Lock()
_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, dict] = {}


def _build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def _digest(name: str, csrc: Path | None = None) -> str:
    """Hash of ``<csrc>/<name>.cu``, every ``<csrc>/*.cuh`` (in name order)
    and the flags: what decides whether a built library is current."""
    csrc = CSRC if csrc is None else csrc
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = _digest(name)
        out_dir = _build_dir()
        target = out_dir / f"{name}-{digest}.so"
        log = {"library": str(target), "cached": target.exists(),
               "seconds": 0.0, "compiler_output": ""}
        if not target.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".{name}-{digest}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log["seconds"] = time.perf_counter() - t0
            log["compiler_output"] = (proc.stdout + proc.stderr).strip()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log['compiler_output']}")
            os.replace(tmp, target)   # atomic: no half-written library
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
        _LOGS[name] = log
        return lib


def build_log(name: str) -> dict:
    """Path, build seconds and compiler output (register / shared-memory use
    per kernel from ``-Xptxas -v``) of a library loaded in this process."""
    return dict(_LOGS[name])
