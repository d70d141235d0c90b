"""CPU emulation of the tensor-core arithmetic of K1's and K3's f32 mode
(``csrc/lk_mvm_tc.cuh``) and of K2a and K2b (``csrc/lk_mvm_two_stage.cu``,
``csrc/lk_mvm_stage_left.cu``), shared by the kernel tests. It calls no port code:
it shows, before the card is asked, why the f32 mode takes three TF32
passes, and why each k step's MMAs are summed apart."""
import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on
    the bit pattern, ties away from zero, 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tc_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """float32 a @ b from TF32 operands: 3 passes (hi*hi + hi*lo + lo*hi, as
    the kernel's f32 mode) or 1 (hi*hi). Products exact, summed in float64,
    rounded to float32: only the operands' rounding is emulated."""
    ah, bh = tf32(a), tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out.float()


def _toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero, as the tensor cores' float32
    accumulation truncates."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, per_step: bool,
               interval: int = 1) -> np.ndarray:
    """float32 a @ b as a chain of TF32 MMAs of k = 8 in 3xTF32 (lo*hi,
    hi*lo, hi*hi per k step), each MMA's sum truncated to float32.
    ``per_step=False`` accumulates all of them in place in the output
    fragment, step by step. ``per_step=True`` chains ``interval`` k steps in
    the tensor cores (the promotion interval: 1 for K1's and K2a's mma.sync
    order, 2 for K2b's wgmma chains) into a zeroed fragment,
    the interval's lo products first and then its hi*hi products, and adds
    it to the output with a rounding float32 add."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    ah, bh, al, bl = (x.double().numpy() for x in (ah, bh, al, bl))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    K = a.shape[1]
    step = 8 * (interval if per_step else 1)
    for k0 in range(0, K, step):
        ks = [slice(k, k + 8) for k in range(k0, min(k0 + step, K), 8)]
        if per_step:
            parts = [p for s in ks for p in (al[:, s] @ bh[s], ah[:, s] @ bl[s])]
            parts += [ah[:, s] @ bh[s] for s in ks]
        else:
            parts = [p for s in ks for p in (al[:, s] @ bh[s], ah[:, s] @ bl[s],
                                             ah[:, s] @ bh[s])]
        d = np.zeros_like(acc) if per_step else acc
        for p in parts:
            d = _toward_zero(d.astype(np.float64) + p)
        acc = (acc + d).astype(np.float32) if per_step else d
    return acc
