"""RBF-ARD Gram matrix: the GPU kernel's wrapper and its plain version.

Computes   K[i, j] = outputscale * exp(-0.5 * ||(x1_i - x2_j) / l||^2)

:func:`rbf_gram_cuda`
    One launch of the hand-written CUDA kernel ``csrc/rbf_gram.cu`` (kernel
    K4, in the place of the reference's TPU kernel ``rbf_gram_pallas`` in
    ``repro/kernels/gram.py``). The wrapper forms ``z = x / l``; the kernel
    accumulates ``z1_i . z2_j`` and both row norms over d and applies the exp
    epilogue before its one write of K. It computes in float32 and returns
    x1's dtype. A CUDA tensor launches the kernel or raises; a CPU tensor
    runs the plain version.

:func:`rbf_gram_plain`
    The same function in plain PyTorch with the same rounding points. The
    tests and CPU tensors use it.

As in the reference, ``gram_matrices`` does not go through this kernel
(it calls ``core.gp_kernels.rbf_ard``); it is reached through
:func:`repro_torch.kernels.ops.rbf_gram_op`.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .lk_mvm import _raise_on_launch_error, _refuse_autograd

__all__ = ["rbf_gram_cuda", "rbf_gram_plain"]

_LIB = None


def _library():
    """Build/load the kernel's library and declare its C signature."""
    global _LIB
    if _LIB is None:
        lib = load_library("rbf_gram")
        p, i = ctypes.c_void_p, ctypes.c_int
        # (z1, z2, outputscale, out, n, p, d, stream)
        lib.rbf_gram_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.rbf_gram_launch.restype = i
        lib.rbf_gram_error_string.argtypes = [i]
        lib.rbf_gram_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _scaled_inputs(x1, x2, lengthscale):
    """``z = x / l`` in the inputs' dtype, then float32, as the reference
    (which divides before its kernel and casts inside it)."""
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
    _refuse_autograd(x1, x2, lengthscale)
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
        _refuse_autograd(outputscale)
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
    returns (n, p) in x1's dtype.

    On a CUDA tensor this launches the kernel on the current stream without
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
    z1, z2 = _scaled_inputs(x1, x2, lengthscale)
    (n, d), p = z1.shape, z2.shape[0]
    if n == 0 or p == 0 or d == 0:
        raise ValueError("empty operand")
    if max(n, p, d) >= 2**31:
        raise ValueError("n, p and d must fit in 32-bit integers")
    scale = _scale_scalar(outputscale, x1.device)
    out = torch.empty((n, p), dtype=torch.float32, device=x1.device)
    lib = _library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rbf_gram_launch(z1.data_ptr(), z2.data_ptr(),
                                 scale.data_ptr(), out.data_ptr(), n, p, d,
                                 stream)
    _raise_on_launch_error(rc, lib.rbf_gram_error_string, "rbf_gram",
                           (n, p, d))
    rbf_gram_cuda.launches += 1
    return out.to(x1.dtype)


rbf_gram_cuda.launches = 0
