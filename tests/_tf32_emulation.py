"""CPU emulation of the tensor-core arithmetic of K1's and K3's f32 mode
(``csrc/lk_mvm_tc.cuh``), shared by the kernel tests. It calls no port code:
it shows, before the card is asked, why the f32 mode takes three TF32
passes."""
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
