// Fused masked latent-Kronecker MVM for ONE row shard, for NVIDIA Hopper (sm_90a).
//
//   out[b] = mask_rows * (K1_rows @ (um_full[b] @ K2)) + noise * (mask_rows * u_rows[b])
//
// K1_rows (n_local, n) with row stride ldk1, K2 (m, m) with row stride ldk2,
// um_full (B, n, m) the pre-masked input mask * u over ALL n rows (gathered
// from every shard by the caller), mask_rows (n_local, m) and u_rows
// (B, n_local, m) this shard's rows, out (B, n_local, m), noise a scalar read
// through a device pointer. All float32; precision = bf16 rounds K1_rows, K2,
// um_full, u_rows and T to bfloat16 and sums in float32.
//
// Replaces the TPU kernel `lk_mvm_fused_rows` / `_fused_rows_kernel` of the
// reference (src/repro/kernels/lk_mvm.py), the per-shard body of its
// distributed engine. The body is K1's tensor-core kernel (lk_mvm_tc.cuh)
// made rectangular; what differs from K1's instantiation:
//
// * The k sweep runs over the n GLOBAL rows of um_full (the columns of
//   K1_rows), the output rows over the shard's n_local rows. Stage R forms T
//   from um_full as it is: no mask there, the caller masked it.
// * The epilogue reads the dedicated mask_rows / u_rows inputs at the local
//   tile. The reference's square kernel captured them at k == i, which row
//   sharding makes invalid (the global k and the local i never line up except
//   on shard 0).
// * The batch goes through ONE launch, folded into the GEMM's columns. The
//   reference maps its rank-2 shard body over the batch, an artefact of its
//   shard_map, not of the function.
//
// What bounds it: 2 B (n m^2 + n_local n m) flops against 4 (n_local n +
// B n m + 3 B n_local m + m^2) bytes, so operations at B = 65 (3xTF32 in f32
// mode, BF16 MMA in bf16 mode) and bytes at B = 1; the header says what the
// design does about each.

#include "lk_mvm_tc.cuh"

// Launches the kernel on `stream` with the grid of `plan` (the wrapper's
// planner); returns the CUDA error code of the launch (0 = success). Does
// not synchronise and allocates nothing.
extern "C" int lk_mvm_fused_rows_launch(const void* K1_rows, long long ldk1,
                                        const void* K2, long long ldk2,
                                        const void* um_full,
                                        const void* mask_rows,
                                        const void* u_rows, const void* noise,
                                        void* out, int B, int n_local, int n,
                                        int m, int bf16,
                                        const lk_tc::Plan* plan,
                                        void* stream) {
    lk_tc::Args p;
    p.A = (const float*)K1_rows;
    p.lda = ldk1;
    p.K2 = (const float*)K2;
    p.ldk2 = ldk2;
    p.um = (const float*)um_full;
    p.mask_p = nullptr;
    p.mask_e = (const float*)mask_rows;
    p.u_e = (const float*)u_rows;
    p.noise = (const float*)noise;
    p.out = (float*)out;
    p.B = B;
    p.n_rows = n_local;
    p.n = n;
    p.m = m;
    p.plan = *plan;
    return lk_tc::launch<false>(p, bf16, stream);
}

// The runtime's view of the instantiations this launcher picks from
// (lk_tc::attributes: 0 f32 / 16-byte copies, 1 f32 / 4-byte, 2 bf16 /
// 16-byte, 3 bf16 / 4-byte); the budget model (kernels/budget.py) is held
// against it.
extern "C" int lk_mvm_fused_rows_attributes(int which, KernelAttr* out) {
    return lk_tc::attributes<false>(which, out);
}

// Human-readable name of an error code returned by lk_mvm_fused_rows_launch.
extern "C" const char* lk_mvm_fused_rows_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
