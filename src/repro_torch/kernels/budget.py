"""Budget model of the CUDA kernels: what one block holds, and how many fit.

Counterpart of ``repro.analysis.vmem``, the reference's exact VMEM model of
its TPU kernel. On the TPU the scarce resource was one core's 16 MiB of
VMEM; on Hopper it is what one SM holds at once: shared memory (228 KB an
SM, 227 KB a block at most, 1 KB of each block's reserved by the runtime),
registers (65,536 an SM) and threads (2,048). So the model is per kernel
instantiation, not per block-size choice:

* :data:`INSTANTIATIONS` — every instantiation a launcher picks from, with
  its threads per block, its ``__launch_bounds__`` minimum blocks per SM
  (hence its register cap), and its shared memory, computed from the
  kernel's constants one to one (:func:`tc_smem_bytes` mirrors
  ``lk_tc::Layout`` of ``csrc/lk_mvm_tc.cuh``, :func:`stream_smem_bytes`
  ``lk_two_stage::BYTES`` of ``csrc/lk_mvm_two_stage.cu``,
  :func:`stage_left_smem_bytes` ``lk_wg::Smem<BN>::BYTES`` of
  ``csrc/lk_mvm_stage_left.cu``,
  :func:`gram_smem_bytes` ``rbf::Shape::SMEM`` of ``csrc/rbf_gram.cu``);
* :class:`DeviceLimits` — the card's limits, :data:`H100_SXM` for the card
  the port targets, :func:`device_limits` read from a CUDA device;
* :meth:`BlockBudget.blocks_per_sm` / :meth:`BlockBudget.fits` — resident
  blocks per SM under those limits, and whether the instantiation launches
  at all.

Each launcher source exports ``<library>_attributes(which, out)`` built on
``cudaFuncGetAttributes`` and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
(``csrc/kernel_attr.cuh``); :func:`kernel_attributes` reads it, and
``chip_smoke.py`` holds the model against it on the card. Pure Python: no
``torch.cuda`` at import.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

from ._build import CKernelAttr, load_library

__all__ = ["DeviceLimits", "H100_SXM", "device_limits", "BlockBudget",
           "INSTANTIATIONS", "tc_smem_bytes", "stream_smem_bytes",
           "stage_left_smem_bytes", "gram_smem_bytes", "kernel_attributes", "GRAM_VARIANTS"]

FLOAT = 4   # bytes of a float32 in shared memory


@dataclass(frozen=True)
class DeviceLimits:
    """What one SM of a card holds, and how many SMs it has."""

    sms: int
    smem_per_block_optin: int        # largest shared memory one block may use
    smem_per_sm: int                 # shared memory of one SM
    regs_per_sm: int = 65536
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    reserved_smem_per_block: int = 1024   # the runtime's share of each block's
    reg_alloc_unit: int = 256        # registers are given to warps in these units
    sub_partitions: int = 4          # an SM's register file is split among them
    name: str = ""


# NVIDIA H100 SXM (sm_90): 132 SMs, 228 KB of shared memory an SM, 227 KB a
# block (cudaDevAttrMaxSharedMemoryPerBlockOptin), 1 KB reserved per block.
H100_SXM = DeviceLimits(sms=132, smem_per_block_optin=232448,
                        smem_per_sm=233472, name="H100 SXM (data sheet)")


def device_limits(device) -> DeviceLimits:
    """The limits of a CUDA device, read once per device through the CUDA
    runtime (``cudaDeviceGetAttribute``, the entry point
    ``repro_device_limits`` of every kernel library)."""
    import torch
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    limits = _LIMITS.get(index)
    if limits is None:
        vals = (ctypes.c_int * 7)()
        rc = load_library("rbf_gram").repro_device_limits(index, vals)
        if rc != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute on cuda:{index} "
                               f"failed: CUDA error {rc}")
        limits = _LIMITS[index] = DeviceLimits(
            sms=vals[0], smem_per_block_optin=vals[1], smem_per_sm=vals[2],
            regs_per_sm=vals[3], max_threads_per_sm=vals[4],
            max_blocks_per_sm=vals[5], reserved_smem_per_block=vals[6],
            name=torch.cuda.get_device_name(index))
    return limits


_LIMITS: dict[int, DeviceLimits] = {}


def tc_smem_bytes(bf16: bool) -> int:
    """Dynamic shared memory of the tensor-core body (K1, K3):
    ``lk_tc::Layout<BF16>::BYTES`` - a two-stage ring of (A tile, U tiles,
    mask tile), K2^T (split into TF32 halves in f32 mode) and T^T (halves in
    f32 mode)."""
    BM, BN, TK, STAGES = 256, 128, 32, 2
    lda = ldt = TK + (16 if bf16 else 8)
    ldu_max = 80 if bf16 else 72
    u_floats = 6144 if bf16 else 5120
    halves = 1 if bf16 else 2
    mk = TK * ldu_max
    k2t = halves * 64 * ldu_max
    stage = BM * lda + u_floats + mk
    t = halves * BN * ldt
    return (STAGES * stage + k2t + t) * FLOAT


def stream_smem_bytes() -> int:
    """Dynamic shared memory of K2a: ``lk_two_stage::BYTES`` - a three-deep
    ring of 64-row U tiles, the mask tile and K2^T as (hi, lo) pairs (the
    wide kernel's double-buffered ring of U, mask and K2 chunks fits in it
    and launches with it)."""
    SR, STAGES, KR_MAX = 64, 3, 64
    slot = SR * (KR_MAX + 8)
    k2t = KR_MAX * (2 * KR_MAX + 16)
    return (STAGES * slot + slot + k2t) * FLOAT


def stage_left_smem_bytes(col_tile: int) -> int:
    """Dynamic shared memory of K2b: ``lk_wg::Smem<BN>::BYTES`` - a
    three-stage TMA ring of (K1_hi, K1_lo, T_hi, T_lo) k tiles of 32 floats
    by 128 rows (K1) and ``col_tile`` rows (T^T), its full and empty
    barriers, and 1024 bytes to align the ring to the 128-byte swizzle's
    period."""
    BM, BK, STAGES = 128, 32, 3
    stage = 2 * BM * BK * FLOAT + 2 * col_tile * BK * FLOAT
    return STAGES * stage + 2 * STAGES * 8 + 1024


# K2b's threads: two consumer warpgroups and a producer warpgroup.
STAGE_LEFT_THREADS = 384


# K4's instantiations along d: (name, d in registers), as rbf::Variant.
GRAM_VARIANTS = (("d<=8", 8), ("d<=16", 16), ("chunked", 16))
GRAM_THREADS = 256


def gram_smem_bytes(dk: int) -> int:
    """Static shared memory of K4: ``rbf::Shape::SMEM`` - each of the 8
    warps stages 32 rows of dk values, the norm and padding to 16 bytes."""
    warps, rows = GRAM_THREADS // 32, 32
    return warps * rows * (dk + 4) * FLOAT


@dataclass(frozen=True)
class BlockBudget:
    """One kernel instantiation: what one block holds.

    ``library`` and ``which`` name it in ``<library>_attributes(which)``;
    ``min_blocks`` is its ``__launch_bounds__`` second argument, from which
    the compiler caps its registers (:attr:`reg_cap`)."""

    name: str
    library: str
    which: int
    threads: int
    min_blocks: int
    static_smem: int
    dynamic_smem: int

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem

    @property
    def reg_cap(self) -> int:
        """Registers a thread may use: what lets ``min_blocks`` blocks share
        the 65,536 registers of an SM, in the allocation's units of 8, at
        most 255."""
        per_thread = 65536 // (self.threads * self.min_blocks)
        return min(255, per_thread // 8 * 8)

    def blocks_per_sm(self, limits: DeviceLimits = H100_SXM,
                      regs: int | None = None) -> int:
        """Blocks resident on one SM, limited by shared memory (with the
        runtime's reserve per block), registers (``regs`` a thread, default
        the cap; given to warps in units of 256), threads and the block
        count. 0 when one block does not fit. A warp's registers come from
        one of the SM's four sub-partitions, so the register limit is taken
        per sub-partition, as the runtime's occupancy calculator does."""
        if self.smem > limits.smem_per_block_optin:
            return 0
        regs = self.reg_cap if regs is None else regs
        warps = -(-self.threads // 32)
        unit = limits.reg_alloc_unit
        per_warp = -(-regs * 32 // unit) * unit
        parts = limits.sub_partitions
        by_regs = limits.regs_per_sm // parts // per_warp * parts // warps
        by_smem = limits.smem_per_sm // (self.smem
                                         + limits.reserved_smem_per_block)
        by_threads = limits.max_threads_per_sm // self.threads
        return min(by_regs, by_smem, by_threads, limits.max_blocks_per_sm)

    def fits(self, limits: DeviceLimits = H100_SXM) -> bool:
        """Whether a block of it launches on the card at all."""
        return self.blocks_per_sm(limits) >= 1


def _instantiations() -> dict[str, BlockBudget]:
    tc = {False: tc_smem_bytes(False), True: tc_smem_bytes(True)}
    out = []
    for lib, kernel in (("lk_mvm_fused", "K1"), ("lk_mvm_fused_rows", "K3")):
        for which, (prec, copies) in enumerate(
                [("f32", 16), ("f32", 4), ("bf16", 16), ("bf16", 4)]):
            out.append(BlockBudget(f"{kernel} {prec} {copies}B", lib, which,
                                   512, 1, 0, tc[prec == "bf16"]))
    for which, col_tile in enumerate((128, 64)):
        out.append(BlockBudget(f"K2b wgmma{col_tile}", "lk_mvm_stage_left",
                               which, STAGE_LEFT_THREADS, 1, 0,
                               stage_left_smem_bytes(col_tile)))
    for which, (copies, cols) in enumerate(
            [(16, "full"), (16, "ragged"), (4, "full"), (4, "ragged"),
             (16, "wide"), (4, "wide")]):
        out.append(BlockBudget(f"K2a {copies}B {cols}", "lk_mvm_two_stage",
                               which, 128, 2, 0, stream_smem_bytes()))
    which = 0
    for x in ("f32", "f64"):
        for o in ("f32", "f64"):
            for variant, dk in GRAM_VARIANTS:
                out.append(BlockBudget(
                    f"K4 x{x} out{o} {variant}", "rbf_gram", which,
                    GRAM_THREADS, 3 if variant == "d<=8" else 2,
                    gram_smem_bytes(dk), 0))
                which += 1
    return {b.name: b for b in out}


INSTANTIATIONS = _instantiations()


def kernel_attributes(b: BlockBudget) -> dict:
    """What the CUDA runtime reports for instantiation ``b`` at its launch
    on the current device (builds its library if needed). Raises on a CUDA
    error."""
    lib = load_library(b.library)
    attr = CKernelAttr()
    rc = getattr(lib, f"{b.library}_attributes")(b.which, ctypes.byref(attr))
    if rc != 0:
        err = getattr(lib, f"{b.library}_error_string")(rc).decode()
        raise RuntimeError(f"{b.library}_attributes({b.which}) failed: CUDA "
                           f"error {rc} ({err})")
    return {f: getattr(attr, f) for f, _ in CKernelAttr._fields_}
