"""Public wrappers that dispatch between the GPU kernels and the plain oracles.

Counterpart of ``repro.kernels.ops``. The rule is by device, never by what
happens to be installed: tensors on a CUDA device go through the kernel (or
raise), tensors on the CPU go to the oracle - or, with ``force_kernel=True``,
through the kernel wrapper's plain version, which keeps the kernel's float32
rounding points. Which MVM kernel runs is the route tuner's choice unless
the caller names it.
"""
from __future__ import annotations

from .._device import check_on_device, resolve_device
from .autotune import autotune_route
from .gram import rbf_gram_cuda
from .lk_mvm import mvm_launch
from .ref import lk_mvm_ref, rbf_gram_ref

__all__ = ["lk_mvm_op", "rbf_gram_op"]


def lk_mvm_op(K1, K2, mask, u, noise=0.0, *, force_kernel: bool = False,
              fused: bool | None = None, precision: str = "f32", device=None):
    """A(u) = mask * (K1 @ (mask*u) @ K2) + noise * (mask*u).

    ``device=None`` means the GPU; the tensors must live on the device named.
    ``fused=True`` is the fused kernel K1, ``fused=False`` the two-stage
    kernels K2a + K2b; ``fused=None`` asks the route tuner
    (:func:`repro_torch.kernels.autotune.autotune_route`: timed on a CUDA
    device, the reference's rule on the CPU), as the reference asks its
    block tuner when no blocks are given. The kernels run through a launch
    of :func:`repro_torch.kernels.lk_mvm.mvm_launch`, made for this call.
    """
    dev = resolve_device(device)
    check_on_device(dev, K1=K1, K2=K2, mask=mask, u=u)
    if dev.type == "cuda" or force_kernel:
        B = u.numel() // max(mask.numel(), 1)
        if fused is None:
            n, m = mask.shape
            fused = autotune_route(n, m, B, precision=precision,
                                   device=dev) == "fused"
        return mvm_launch("fused" if fused else "two_stage", K1, K2, mask,
                          noise, B, precision=precision)(u)
    return lk_mvm_ref(K1, K2, mask, u, noise)


def rbf_gram_op(x1, x2, lengthscale, outputscale=1.0, *,
                force_kernel: bool = False, device=None):
    """RBF-ARD Gram matrix between x1 (n, d) and x2 (p, d).

    ``device=None`` means the GPU; the tensors must live on the device named.
    On CUDA this is kernel K4 (:func:`repro_torch.kernels.gram.rbf_gram_cuda`,
    float32 compute, x1's dtype out). On the CPU it is the oracle, or with
    ``force_kernel=True`` the kernel wrapper's plain version.
    """
    dev = resolve_device(device)
    check_on_device(dev, x1=x1, x2=x2, lengthscale=lengthscale,
                    outputscale=outputscale)
    if dev.type == "cuda" or force_kernel:
        return rbf_gram_cuda(x1, x2, lengthscale, outputscale)
    return rbf_gram_ref(x1, x2, lengthscale, outputscale)
