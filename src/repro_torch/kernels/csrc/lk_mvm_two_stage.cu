// Two-stage masked latent-Kronecker matrix-vector product for NVIDIA Hopper
// (sm_90a): the same function as lk_mvm_fused.cu in two launches, with the
// intermediate T in device memory between them.
//
//   stage R (K2a):  T[b]   = (mask * U[b]) @ K2                       (float32)
//   stage L (K2b):  out[b] = mask * (K1 @ T[b]) + noise * (mask * U[b])
//
// K1 (n, n) and K2 (m, m) with unit stride along their rows and row strides
// ldk1 / ldk2, mask (n, m) of 0/1 floats, U, T and out (B, n, m) contiguous,
// noise a scalar read through a device pointer. All float32.
//
// Replaces the TPU kernels of `lk_mvm_two_stage` in the reference
// (src/repro/kernels/lk_mvm.py): `_stage_right_kernel` and
// `_stage_left_kernel`. The reference accumulates over its innermost grid axis
// into a scratch tile, which runs in order on one core; here one block owns
// an output tile and loops over the reduction itself. The reference pads every
// operand to block multiples on the host; here every load is guarded and
// scalar (neighbouring threads on neighbouring addresses), so ragged n and m
// (n < 8, rows of 50 or 52 floats) need no padding copies.
//
// Both stages are the same tiled SIMT GEMM: an output tile of TI x TJ = 128 x
// 64 per block of 256 threads, each thread an 8 x 4 micro-tile, the reduction
// swept in steps of TK = 32 through static shared memory (the A tile stored
// transposed, 25 KB in all, under the 48 KB that needs no opt-in). Only where
// the operands come from and the epilogue differ:
//
// * stage R multiplies the (B n, m) matrix (mask * U) by K2. The mask is
//   applied as U's tile enters shared memory (the prologue); the grid runs
//   over ceil(B n / 128) row blocks and ceil(m / 64) column blocks.
// * stage L multiplies K1 by T[b] for each b. Its epilogue reads mask and U at
//   the output tile and writes mask * acc + noise * (mask * U). The grid is
//   (B, ceil(n / 128), ceil(m / 64)) with b fastest, so blocks that run
//   together share one K1 row strip in L2.
//
// Bound on this card: operations, as for the fused kernel. Stage L does
// 2 B n^2 m flops against 4 (n^2 + 3 B n m + n m) bytes (about 800 flops per
// byte at B = 65, n = 8192, m = 64); stage R does 2 B n m^2 flops against
// 4 (m^2 + 2 B n m + n m) bytes, 16 flops per byte at m = 64, so it is near
// the ridge and T's round trip through device memory costs it as much as its
// arithmetic. FMAs only: no tensor cores, no TMA, no software pipelining yet.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TI = 128;        // output rows per block
constexpr int TJ = 64;         // output columns per block
constexpr int TK = 32;         // reduction step
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr int AS_LD = TI + 4;  // A tile, stored transposed [TK][AS_LD]

static_assert(TI == 8 * 16 && TJ == 4 * 16, "thread mapping assumes 16 x 16 threads");
static_assert((AS_LD % 4) == 0 && (TJ % 4) == 0, "float4 rows need 16-byte strides");

// acc[8][4] += A[rows 8 ty .. 8 ty + 7, :] @ Bt[:, cols 4 tx .. 4 tx + 3] over
// one reduction step held in shared memory.
__device__ __forceinline__ void tile_fma(const float* As, const float* Bs,
                                         int tx, int ty, float (&acc)[8][4]) {
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + 8 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + 8 * ty + 4]);
        const float4 w = *reinterpret_cast<const float4*>(&Bs[kk * TJ + 4 * tx]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
    }
}

// Stage R: T = (mask * U) @ K2, U and T viewed as (B n, m).
__global__ void __launch_bounds__(NTHREADS)
stage_right_kernel(const float* __restrict__ U, const float* __restrict__ mask,
                   const float* __restrict__ K2, long long ldk2,
                   float* __restrict__ T, long long rows, int n, int m) {
    __shared__ __align__(16) float As[TK * AS_LD];   // (mask*U)[row block, k-step], transposed
    __shared__ __align__(16) float Bs[TK * TJ];      // K2[k-step, col block]
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const long long r0 = (long long)blockIdx.x * TI;
    const int j0 = blockIdx.y * TJ;

    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < m; k0 += TK) {
        // Everyone is done with the previous step's tiles.
        __syncthreads();
        for (int idx = tid; idx < TI * TK; idx += NTHREADS) {
            const int r = idx / TK, c = idx % TK;
            const long long gr = r0 + r;
            const int gk = k0 + c;
            float v = 0.f;
            if (gr < rows && gk < m) {
                const long long i = gr % n;   // row of the mask
                v = mask[i * m + gk] * U[gr * m + gk];
            }
            As[c * AS_LD + r] = v;
        }
        for (int idx = tid; idx < TK * TJ; idx += NTHREADS) {
            const int kk = idx / TJ, c = idx % TJ;
            const int gk = k0 + kk, gc = j0 + c;
            float v = 0.f;
            if (gk < m && gc < m) v = K2[(size_t)gk * ldk2 + gc];
            Bs[kk * TJ + c] = v;
        }
        __syncthreads();
        tile_fma(As, Bs, tx, ty, acc);
    }

#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const long long gr = r0 + 8 * ty + r;
        if (gr >= rows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int gc = j0 + 4 * tx + c;
            if (gc < m) T[gr * m + gc] = acc[r][c];
        }
    }
}

// Stage L: out[b] = mask * (K1 @ T[b]) + noise * (mask * U[b]).
__global__ void __launch_bounds__(NTHREADS)
stage_left_kernel(const float* __restrict__ K1, long long ldk1,
                  const float* __restrict__ T, const float* __restrict__ mask,
                  const float* __restrict__ U,
                  const float* __restrict__ noise_ptr,
                  float* __restrict__ out, int n, int m) {
    __shared__ __align__(16) float As[TK * AS_LD];   // K1[row block, k-step], transposed
    __shared__ __align__(16) float Bs[TK * TJ];      // T[b][k-step, col block]
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int b = blockIdx.x;
    const int i0 = blockIdx.y * TI;
    const int j0 = blockIdx.z * TJ;
    const size_t plane = (size_t)n * (size_t)m;
    const float* Tb = T + (size_t)b * plane;

    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < n; k0 += TK) {
        __syncthreads();
        for (int idx = tid; idx < TI * TK; idx += NTHREADS) {
            const int r = idx / TK, c = idx % TK;
            const int gr = i0 + r, gk = k0 + c;
            float v = 0.f;
            if (gr < n && gk < n) v = K1[(size_t)gr * ldk1 + gk];
            As[c * AS_LD + r] = v;
        }
        for (int idx = tid; idx < TK * TJ; idx += NTHREADS) {
            const int kk = idx / TJ, c = idx % TJ;
            const int gk = k0 + kk, gc = j0 + c;
            float v = 0.f;
            if (gk < n && gc < m) v = Tb[(size_t)gk * m + gc];
            Bs[kk * TJ + c] = v;
        }
        __syncthreads();
        tile_fma(As, Bs, tx, ty, acc);
    }

    // Epilogue at tile (i, j): mask and U read once, here.
    const float noise = *noise_ptr;
    const float* Ub = U + (size_t)b * plane;
    float* outb = out + (size_t)b * plane;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int gr = i0 + 8 * ty + r;
        if (gr >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int gc = j0 + 4 * tx + c;
            if (gc >= m) continue;
            const size_t o = (size_t)gr * m + gc;
            const float mk = mask[o];
            outb[o] = mk * acc[r][c] + noise * (mk * Ub[o]);
        }
    }
}

}  // namespace

// Launches stage R on `stream`; returns the CUDA error code of the launch
// (0 = success). Does not synchronise and allocates nothing.
extern "C" int lk_mvm_stage_right_launch(const void* U, const void* mask,
                                         const void* K2, long long ldk2,
                                         void* T, int B, int n, int m,
                                         void* stream) {
    if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const long long rows = (long long)B * n;
    const long long gx = (rows + TI - 1) / TI;
    const long long gy = ((long long)m + TJ - 1) / TJ;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gx, (unsigned)gy, 1);
    stage_right_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)U, (const float*)mask, (const float*)K2, ldk2,
        (float*)T, rows, n, m);
    return (int)cudaGetLastError();
}

// Launches stage L on `stream`; same contract as stage R.
extern "C" int lk_mvm_stage_left_launch(const void* K1, long long ldk1,
                                        const void* T, const void* mask,
                                        const void* U, const void* noise,
                                        void* out, int B, int n, int m,
                                        void* stream) {
    if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const long long gy = ((long long)n + TI - 1) / TI;
    const long long gz = ((long long)m + TJ - 1) / TJ;
    if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)B, (unsigned)gy, (unsigned)gz);
    stage_left_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)K1, ldk1, (const float*)T, (const float*)mask,
        (const float*)U, (const float*)noise, (float*)out, n, m);
    return (int)cudaGetLastError();
}

// Human-readable name of an error code returned by the launch functions.
extern "C" const char* lk_mvm_two_stage_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
