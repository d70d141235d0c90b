// Fused masked latent-Kronecker matrix-vector product for NVIDIA Hopper (sm_90a).
//
//   out[b] = mask * (K1 @ ((mask * U[b]) @ K2)) + noise * (mask * U[b])
//
// K1 (n, n) with row stride ldk1, K2 (m, m) with row stride ldk2, mask (n, m)
// of 0/1 floats, U and out (B, n, m), noise a scalar read through a device
// pointer. All float32; precision = bf16 rounds K1, K2, U and the
// intermediate T to bfloat16 and sums in float32.
//
// Replaces the TPU kernel `lk_mvm_fused` / `_fused_kernel` of the reference
// (src/repro/kernels/lk_mvm.py). What is kept from it is WHAT it computes and
// what it keeps out of device memory: the (B, n, m) intermediate
// T = (mask * U) @ K2 is never written to device memory. The mask/U tile of
// the epilogue is read at the output tile (i, j); the reference's capture at
// k == i is an artefact of its sweep order.
//
// The body is the tensor-core kernel of lk_mvm_tc.cuh, instantiated here with
// the mask applied to U where U's tiles enter stage R (the prologue) and the
// epilogue reading mask and U themselves. What bounds it on this card: at
// (B, n, m) = (65, 8192, 64) the function needs 2 B (n^2 m + n m^2) = 563
// GFLOP against 543 MB, so operations, at the 3xTF32 rate (495 / 3 TFLOP/s)
// in f32 mode and the BF16 rate in bf16 mode; at B = 1 the bytes (K1 once,
// 269 MB). The design answers the first with tensor cores and 128 batch
// columns per loaded K1 tile, the second with split-k clusters that put
// enough blocks on the card to stream K1 (see the header).

#include "lk_mvm_tc.cuh"

// Launches the kernel on `stream` with the grid of `plan` (the wrapper's
// planner); returns the CUDA error code of the launch (0 = success). Does
// not synchronise and allocates nothing.
extern "C" int lk_mvm_fused_launch(const void* K1, long long ldk1,
                                   const void* K2, long long ldk2,
                                   const void* mask, const void* U,
                                   const void* noise, void* out,
                                   int B, int n, int m, int bf16,
                                   const lk_tc::Plan* plan, void* stream) {
    lk_tc::Args p;
    p.A = (const float*)K1;
    p.lda = ldk1;
    p.K2 = (const float*)K2;
    p.ldk2 = ldk2;
    p.um = (const float*)U;
    p.mask_p = (const float*)mask;
    p.mask_e = (const float*)mask;
    p.u_e = (const float*)U;
    p.noise = (const float*)noise;
    p.out = (float*)out;
    p.B = B;
    p.n_rows = n;
    p.n = n;
    p.m = m;
    p.plan = *plan;
    return lk_tc::launch<true>(p, bf16, stream);
}

// The runtime's view of the instantiations this launcher picks from
// (lk_tc::attributes: 0 f32 / 16-byte copies, 1 f32 / 4-byte, 2 bf16 /
// 16-byte, 3 bf16 / 4-byte); the budget model (kernels/budget.py) is held
// against it.
extern "C" int lk_mvm_fused_attributes(int which, KernelAttr* out) {
    return lk_tc::attributes<true>(which, out);
}

// Human-readable name of an error code returned by lk_mvm_fused_launch.
extern "C" const char* lk_mvm_fused_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
