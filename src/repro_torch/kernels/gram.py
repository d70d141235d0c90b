"""RBF-ARD Gram matrix: the GPU kernel's wrapper and its plain version.

Computes   K[i, j] = outputscale * exp(-0.5 * ||(x1_i - x2_j) / l||^2)

:func:`rbf_gram_cuda`
    One launch of the hand-written CUDA kernel ``csrc/rbf_gram.cu`` (kernel
    K4, in the place of the reference's TPU kernel ``rbf_gram_pallas`` in
    ``repro/kernels/gram.py``). The kernel reads x1, x2 and the lengthscales
    as they are (float32 or float64), forms ``z = x / l`` where it loads
    them, accumulates ``z1_i . z2_j`` and the row norms in float32 and
    writes K from its epilogue in x1's dtype: no pass before or after it.
    Its grid is :func:`plan_gram`'s: persistent blocks, as many as the
    budget model lets share each SM of the device. A CUDA tensor launches
    the kernel or raises; a CPU tensor runs the plain version.

:func:`rbf_gram_plain`
    The same function in plain PyTorch with the same rounding points. The
    tests and CPU tensors use it.

As in the reference, ``gram_matrices`` does not go through this kernel
(it calls ``core.gp_kernels.rbf_ard``); it is reached through
:func:`repro_torch.kernels.ops.rbf_gram_op`.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ._build import CGramPlan, launch, refuse_autograd
from .budget import (GRAM_VARIANTS, H100_SXM, INSTANTIATIONS, DeviceLimits,
                     device_limits)

__all__ = ["rbf_gram_cuda", "rbf_gram_plain", "GramPlan", "plan_gram"]

# csrc/rbf_gram.cu: columns of a warp's column tile (32 lanes x 4), warps of a
# block, and the largest d kept in registers by each instantiation.
GRAM_COLS, GRAM_WARPS = 128, 8
_DTYPES = (torch.float32, torch.float64)


@dataclass(frozen=True)
class GramPlan:
    """One launch of K4: ``col_tiles`` column tiles of GRAM_COLS columns,
    each cut into ``row_chunks`` ranges of rows (range q holds rows
    [q n // row_chunks, (q + 1) n // row_chunks)); unit u = (tile u //
    row_chunks, range u % row_chunks) is walked by warp u mod (8 blocks) of
    the ``blocks`` persistent blocks."""

    n: int
    p: int
    col_tiles: int
    row_chunks: int
    blocks: int

    def c_struct(self) -> CGramPlan:
        """The plan as the kernel's launcher takes it."""
        return CGramPlan(**{f: getattr(self, f) for f, _ in CGramPlan._fields_})

    def units(self, warp: int) -> list[tuple[int, int, int]]:
        """(column tile, first row, end row) of each unit that warp ``warp``
        of the grid walks, in its order: the kernel's own rule."""
        out, step = [], self.blocks * GRAM_WARPS
        for u in range(warp, self.col_tiles * self.row_chunks, step):
            c, q = divmod(u, self.row_chunks)
            out.append((c, q * self.n // self.row_chunks,
                        (q + 1) * self.n // self.row_chunks))
        return out


def gram_variant(d: int) -> str:
    """The K4 instantiation ``d`` takes: d <= 8 and d <= 16 in registers,
    larger d in chunks (csrc/rbf_gram.cu: rbf::Variant)."""
    return next((name for name, dk in GRAM_VARIANTS[:2] if d <= dk),
                GRAM_VARIANTS[2][0])


@functools.lru_cache(maxsize=256)
def plan_gram(n: int, p: int, d: int, *, sms: int,
              limits: DeviceLimits = H100_SXM) -> GramPlan:
    """K4's grid on a card of ``sms`` SMs: persistent blocks, as many per SM
    as the budget of ``d``'s instantiation admits under ``limits`` (three or
    two on an H100), at most one warp per unit; the rows of each column tile
    cut into as many ranges as there are warps per column tile, each at
    least 8 rows long."""
    if min(n, p, d) <= 0:
        raise ValueError("empty operand")
    per_sm = INSTANTIATIONS[f"K4 xf32 outf32 {gram_variant(d)}"].blocks_per_sm(
        limits)
    if per_sm < 1:
        raise ValueError(f"K4's block does not fit an SM of {limits}")
    col_tiles = -(-p // GRAM_COLS)
    warps = per_sm * sms * GRAM_WARPS
    row_chunks = max(1, min(warps // col_tiles, -(-n // 8)))
    units = col_tiles * row_chunks
    if max(col_tiles, row_chunks) >= 2**31:
        raise ValueError(f"({n}, {p}) is more than a launch takes")
    blocks = min(per_sm * sms, -(-units // GRAM_WARPS))
    return GramPlan(n=n, p=p, col_tiles=col_tiles, row_chunks=row_chunks,
                    blocks=blocks)


def _check_inputs(x1, x2, lengthscale):
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"x1 and x2 must be (n, d) and (p, d), got "
                         f"{tuple(x1.shape)} and {tuple(x2.shape)}")
    d = x1.shape[1]
    if lengthscale.shape not in ((d,), ()):
        raise ValueError(f"lengthscale must be ({d},), got "
                         f"{tuple(lengthscale.shape)}")
    for name, x in (("x2", x2), ("lengthscale", lengthscale)):
        if x.device != x1.device:
            raise ValueError(f"{name} lives on {x.device}, x1 on {x1.device}")
    if not (x1.dtype.is_floating_point and x2.dtype.is_floating_point):
        raise TypeError("x1 and x2 must be floating point")
    refuse_autograd(x1, x2, lengthscale)


def _scaled_inputs(x1, x2, lengthscale):
    """``z = x / l`` in the inputs' dtype, then float32, as the reference
    (which divides before its kernel and casts inside it)."""
    _check_inputs(x1, x2, lengthscale)
    f32 = torch.float32
    z1 = (x1 / lengthscale).to(f32).contiguous()
    z2 = (x2 / lengthscale).to(f32).contiguous()
    return z1, z2


def _scale_scalar(outputscale, device) -> torch.Tensor:
    """``outputscale`` as a 0-d float32 tensor on ``device`` (no host sync
    when it is already a tensor there)."""
    if isinstance(outputscale, torch.Tensor):
        if outputscale.numel() != 1:
            raise ValueError("outputscale must be a scalar")
        refuse_autograd(outputscale)
        return outputscale.detach().reshape(()).to(device=device,
                                                   dtype=torch.float32)
    return torch.tensor(float(outputscale), dtype=torch.float32, device=device)


def rbf_gram_plain(x1: torch.Tensor, x2: torch.Tensor,
                   lengthscale: torch.Tensor, outputscale=1.0) -> torch.Tensor:
    """Plain version of :func:`rbf_gram_cuda`: float32 ``z = x / l``, the
    expansion ``|z1|^2 + |z2|^2 - 2 z1 . z2`` clamped at 0, the float32
    exp epilogue, the result cast to x1's dtype."""
    z1, z2 = _scaled_inputs(x1, x2, torch.as_tensor(lengthscale,
                                                    device=x1.device))
    sq = ((z1 * z1).sum(1)[:, None] + (z2 * z2).sum(1)[None, :]
          - 2.0 * (z1 @ z2.T))
    k = _scale_scalar(outputscale, x1.device) * torch.exp(
        -0.5 * torch.clamp(sq, min=0.0))
    return k.to(x1.dtype)


def rbf_gram_cuda(x1: torch.Tensor, x2: torch.Tensor,
                  lengthscale: torch.Tensor, outputscale=1.0) -> torch.Tensor:
    """Kernel K4: the RBF-ARD Gram matrix between x1 (n, d) and x2 (p, d).

    ``lengthscale`` is (d,); ``outputscale`` a number or a 0-d tensor (read by
    the kernel through a device pointer: no host sync). Computes in float32,
    returns (n, p) in x1's dtype, written by the kernel itself.

    On a CUDA tensor, x1, x2 and the lengthscales are float32 or float64;
    the kernel divides in the dtype the three promote to (float64 if any is
    float64), which gives the bits of ``(x / l).to(float32)``, and x1 is
    float32 or float64. It launches the kernel on the current stream without
    synchronising, or raises; it never falls back to the plain version. On a
    CPU tensor it runs :func:`rbf_gram_plain`. ``rbf_gram_cuda.launches``
    counts kernel launches.
    """
    lengthscale = torch.as_tensor(lengthscale, device=x1.device)
    if x1.device.type == "cpu":
        return rbf_gram_plain(x1, x2, lengthscale, outputscale)
    if x1.device.type != "cuda":
        raise ValueError(f"rbf_gram_cuda runs on cuda or cpu tensors, not "
                         f"{x1.device}")
    _check_inputs(x1, x2, lengthscale)
    for name, x in (("x1", x1), ("x2", x2), ("lengthscale", lengthscale)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"the Gram kernel takes float32 or float64 "
                            f"{name}, got {x.dtype}")
    (n, d), p = x1.shape, x2.shape[0]
    if n == 0 or p == 0 or d == 0:
        raise ValueError("empty operand")
    if max(n, p, d) >= 2**31:
        raise ValueError("n, p and d must fit in 32-bit integers")
    # The division's dtype. Casting float32 to float64 is exact, and a
    # float32 quotient rounded from float64 is the float32 quotient.
    tx = torch.float64 if torch.float64 in (x1.dtype, x2.dtype,
                                            lengthscale.dtype) \
        else torch.float32
    a, b = (x.detach().to(tx).contiguous() for x in (x1, x2))
    ls = lengthscale.detach().to(tx).expand(d).contiguous()
    scale = _scale_scalar(outputscale, x1.device)
    out = torch.empty((n, p), dtype=x1.dtype, device=x1.device)
    limits = device_limits(x1.device)
    plan = plan_gram(n, p, d, sms=limits.sms, limits=limits)
    launch("rbf_gram", "rbf_gram", (n, p, d), x1.device, a.data_ptr(),
           b.data_ptr(), ls.data_ptr(), int(tx == torch.float64),
           scale.data_ptr(), out.data_ptr(), int(out.dtype == torch.float64),
           n, p, d, ctypes.byref(plan.c_struct()))
    rbf_gram_cuda.launches += 1
    return out


rbf_gram_cuda.launches = 0
