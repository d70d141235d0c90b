"""Builds the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, then loaded with ``ctypes``. The file name carries a
hash of the source, every shared header ``csrc/*.cuh`` and the flags
(:func:`_digest`), so an edited kernel or header rebuilds and a stale library
is never picked up. Nothing is built at import time, and a build failure
raises with the compiler's output; it is never swallowed.

:data:`LIBRARIES` is the C interface of every library, declared on it when
it loads: its entry points with their argument and result types, and the C
structs they take. :func:`launch` is the one call of a kernel's launcher:
on its device, on the current stream, raising on a CUDA error.
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

import torch

__all__ = ["NVCC_FLAGS", "LIBRARIES", "load_library", "build_log", "launch",
           "CPlan", "CStreamPlan", "CLeftPlan", "CGramPlan", "CKernelAttr"]

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


def _c_struct(name: str, doc: str, fields: tuple[str, ...]) -> type:
    return type(name, (ctypes.Structure,), {
        "__doc__": doc, "_fields_": [(f, ctypes.c_int) for f in fields]})


CPlan = _c_struct("CPlan", "``lk_tc::Plan`` of csrc/lk_mvm_tc.cuh.", (
    "row_tiles", "panels", "k_tiles", "col_tile", "batch_per_panel",
    "splits"))
CStreamPlan = _c_struct("CStreamPlan", "``lk_two_stage::StreamPlan`` of "
                        "csrc/lk_mvm_two_stage.cu.",
                        ("strip_rows", "strips", "blocks"))
CLeftPlan = _c_struct("CLeftPlan", "``lk_wg::Plan`` of "
                      "csrc/lk_mvm_stage_left.cu.", (
                          "row_tiles", "col_tiles", "col_tile", "k_tiles",
                          "splits", "blocks"))
CGramPlan = _c_struct("CGramPlan", "``rbf::GramPlan`` of csrc/rbf_gram.cu.",
                      ("col_tiles", "row_chunks", "blocks"))
CKernelAttr = _c_struct("CKernelAttr", "``KernelAttr`` of "
                        "csrc/kernel_attr.cuh.", (
                            "num_regs", "local_bytes", "static_smem",
                            "max_dynamic_smem", "max_threads", "threads",
                            "dynamic_smem", "blocks_per_sm"))

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PTR = ctypes.POINTER
# library -> {entry point: argument types}; every entry point returns a CUDA
# error code (0: none). Each launcher's last argument is the stream. Every
# library also exports <library>_error_string(rc) and
# <library>_attributes(which, KernelAttr*), declared with these, and
# repro_device_limits(device, int[7]), read from rbf_gram.
LIBRARIES = {
    # (K1, ldk1, K2, ldk2, mask, U, noise, out, B, n, m, bf16, plan, stream)
    "lk_mvm_fused": {"lk_mvm_fused_launch": [
        _P, _LL, _P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _PTR(CPlan), _P]},
    # (U, mask, K2, ldk2, T_hi, T_lo, ldt, B, n, m, plan, stream)
    "lk_mvm_two_stage": {"lk_mvm_stage_right_launch": [
        _P, _P, _P, _LL, _P, _P, _LL, _I, _I, _I, _PTR(CStreamPlan), _P]},
    # (K1_hi, K1_lo, ldk, T_hi, T_lo, ldt, mask, U, noise, out, work, B, n,
    #  m, plan, stream)
    "lk_mvm_stage_left": {"lk_mvm_stage_left_launch": [
        _P, _P, _LL, _P, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I,
        _PTR(CLeftPlan), _P]},
    # (K1_rows, ldk1, K2, ldk2, um_full, mask_rows, u_rows, noise, out, B,
    #  n_local, n, m, bf16, plan, stream)
    "lk_mvm_fused_rows": {"lk_mvm_fused_rows_launch": [
        _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _PTR(CPlan), _P]},
    # (x1, x2, ls, x_double, outputscale, out, out_double, n, p, d, plan,
    #  stream); (device, out[7])
    "rbf_gram": {"rbf_gram_launch": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                     _PTR(CGramPlan), _P],
                 "repro_device_limits": [_I, _PTR(_I)]},
}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    entries = {**LIBRARIES.get(name, {}),
               f"{name}_attributes": [_I, _PTR(CKernelAttr)]}
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, _I
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [_I], ctypes.c_char_p


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
    """Compile (if needed) and load ``csrc/<name>.cu`` with its C interface
    declared; cached per process."""
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
        _declare(name, lib)
        _LIBS[name] = lib
        _LOGS[name] = log
        return lib


def build_log(name: str) -> dict:
    """Path, build seconds and compiler output (register / shared-memory use
    per kernel from ``-Xptxas -v``) of a library loaded in this process."""
    return dict(_LOGS[name])


def refuse_autograd(*tensors) -> None:
    """Raise if any tensor would need a gradient: the kernel wrappers have
    no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise NotImplementedError(
            "the kernel wrappers have no backward: differentiate through "
            "repro_torch.core.engines.KernelMVM (K5), or call them under "
            "torch.no_grad() or on detached tensors")


def launch(library: str, kernel: str, shape, device, *args) -> None:
    """``<kernel>_launch(*args, stream)`` of ``library`` on ``device`` and its
    current stream, without synchronising; a CUDA error raises, naming the
    kernel and ``shape``."""
    lib = _LIBS.get(library) or load_library(library)
    with torch.cuda.device(device):
        rc = getattr(lib, f"{kernel}_launch")(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        err = getattr(lib, f"{library}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel} launch failed at shape {shape}: CUDA "
                           f"error {rc} ({err})")
