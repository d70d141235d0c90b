"""Published peaks of the device and the work an MVM sweep needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates without
sparsity, at the full 700 W power limit). The operation and byte counts of
the latent-Kronecker MVM are copied from the program's ``chip_smoke.py``
(``bound_ms``) as it stood when the benchmark was defined, with one change
the benchmark needs: the bound takes the fastest datapath whose range holds
float32 (TF32 on the tensor cores), whatever the kernel computes with, so
that no later kernel can read above 100 %.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES_PER_S", "mvm_flops", "mvm_bytes",
           "least_seconds"]

PEAK_FLOPS = {
    "tf32": 495e12,      # tensor cores, TF32 dense
    "bf16": 989e12,
    "f32": 67e12,        # outside the tensor cores
    "f64": 67e12,        # tensor cores, FP64
}
PEAK_BYTES_PER_S = 3.35e12   # HBM3


def mvm_flops(n: int, m: int, columns: int) -> float:
    """Operations of ``columns`` products ``K1 @ U @ K2`` at (n, m): the two
    matrix products, a multiply and an add each."""
    return 2.0 * columns * (n * n * m + n * m * m)


def mvm_bytes(n: int, m: int, sweeps: int, columns: int) -> float:
    """Bytes of ``sweeps`` sweeps carrying ``columns`` columns in all, in
    float32: K1, K2 and the mask read once a sweep, each column read once and
    written once."""
    return 4.0 * sweeps * (n * n + m * m + n * m) + 8.0 * columns * n * m


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the TF32 peak and the bytes at the memory's."""
    return max(flops / PEAK_FLOPS["tf32"], nbytes / PEAK_BYTES_PER_S)
