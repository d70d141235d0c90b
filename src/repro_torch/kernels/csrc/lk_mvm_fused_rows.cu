// Fused masked latent-Kronecker MVM for ONE row shard, for NVIDIA Hopper (sm_90a).
//
//   out[b] = mask_rows * (K1_rows @ (um_full[b] @ K2)) + noise * (mask_rows * u_rows[b])
//
// K1_rows (n_local, n) with row stride ldk1, K2 (m, m) with row stride ldk2,
// um_full (B, n, m) the pre-masked input mask * u over ALL n rows (gathered
// from every shard by the caller), mask_rows (n_local, m) and u_rows
// (B, n_local, m) this shard's rows, out (B, n_local, m), noise a scalar read
// through a device pointer. All float32.
//
// Replaces the TPU kernel `lk_mvm_fused_rows` / `_fused_rows_kernel` of the
// reference (src/repro/kernels/lk_mvm.py), the per-shard body of its
// distributed engine. It is the design of lk_mvm_fused.cu (K1) made
// rectangular; what differs:
//
// * The k sweep runs over the n GLOBAL rows of um_full (the columns of
//   K1_rows), the output rows over the shard's n_local rows. The stage-R tile
//   T = um_full[b, k-rows, :] @ K2[:, j-cols] is formed in shared memory from
//   um_full as it is: no mask there, the caller masked it.
// * The epilogue reads the dedicated mask_rows / u_rows inputs at the local
//   (i, j) tile. K1's kernel loads them at (i, j) too; the reference's square
//   kernel captured them at k == i, which row sharding makes invalid (the
//   global k and the local i never line up except on shard 0).
// * The batch B goes through ONE launch (grid dimension x). The reference maps
//   its rank-2 shard body over the batch, an artefact of its shard_map, not of
//   the function.
//
// Everything else is K1's: one block per (b, TI-row tile of n_local, TJ-column
// tile of m); the block loops over K1_rows' column blocks k itself (blocks run
// in parallel, so the TPU's sum carried across sequential grid steps becomes
// a loop inside the block); T never reaches device memory and is recomputed
// by every row block (n_local / TI times over, m / TI extra work against the
// main product); guarded scalar loads, no padding copies, any m; precision =
// bf16 rounds K1_rows, K2, um_full, u_rows and T to bfloat16 where they enter
// shared memory or the epilogue and accumulates in float32 (FMAs in both
// modes: bf16 changes the rounding, not the speed).
//
// Bound on this card: operations. 2 B (n m^2 + n_local n m) flops against
// 4 (n_local n + B n m + 3 B n_local m + m^2) bytes; at (B, n_local, n, m) =
// (65, 2048, 8192, 64), one rank's share of a 4-way split, some 700 flops per
// byte. The float32 FMA pipes are the limit of this design, as for K1; the
// tensor cores are the way past it (a later PR).
//
// Tile sizes: TI = 128, TJ = 64, TK = 64, TM = 64, 256 threads, each with an
// 8 x 4 micro-tile of the output and a 4 x 4 micro-tile of T. 65 KB of dynamic
// shared memory (K1_rows tile, which also hosts the um_full chunk, + T tile +
// K2 chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TI = 128;        // output rows per block
constexpr int TJ = 64;         // output columns per block
constexpr int TK = 64;         // K1_rows columns (= rows of T) per sweep step
constexpr int TM = 64;         // chunk of the inner dimension of um_full @ K2
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr int AS_LD = TI + 4;  // K1_rows tile, stored transposed [TK][AS_LD]
constexpr int UM_LD = TK + 4;  // um_full chunk, stored transposed [TM][UM_LD]
constexpr int SMEM_FLOATS = TK * AS_LD + TK * TJ + TM * TJ;

static_assert(TM * UM_LD <= TK * AS_LD, "um_full chunk must fit in the K1 tile's space");
static_assert(TI == 8 * 16 && TJ == 4 * 16 && TK == 4 * 16, "thread mapping assumes 16 x 16 threads");
static_assert((AS_LD % 4) == 0 && (UM_LD % 4) == 0 && (TJ % 4) == 0, "float4 rows need 16-byte strides");

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (BF16) {
        return __bfloat162float(__float2bfloat16_rn(x));
    } else {
        return x;
    }
}

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
lk_mvm_fused_rows_kernel(const float* __restrict__ K1r, long long ldk1,
                         const float* __restrict__ K2, long long ldk2,
                         const float* __restrict__ um,
                         const float* __restrict__ mask_rows,
                         const float* __restrict__ u_rows,
                         const float* __restrict__ noise_ptr,
                         float* __restrict__ out, int n_local, int n, int m) {
    extern __shared__ __align__(16) float smem[];
    float* As = smem;                  // [TK][AS_LD]  K1_rows[i-rows, k-cols], transposed
    float* UMs = smem;                 // [TM][UM_LD]  um_full[k-rows, chunk], transposed;
                                       //              lives in As's space between uses
    float* Ts = smem + TK * AS_LD;     // [TK][TJ]     T[k-rows, j-cols]
    float* K2s = Ts + TK * TJ;         // [TM][TJ]     K2[chunk, j-cols]

    const int tid = threadIdx.x;
    const int tx = tid & 15;           // column group: columns 4*tx .. 4*tx+3
    const int ty = tid >> 4;           // row group
    const int b = blockIdx.x;
    const int i0 = blockIdx.y * TI;    // local output rows
    const int j0 = blockIdx.z * TJ;
    const float* umb = um + (size_t)b * ((size_t)n * (size_t)m);
    const size_t local_plane = (size_t)n_local * (size_t)m;
    const float* ub = u_rows + (size_t)b * local_plane;
    // With m <= TM the K2 column strip is one chunk: load it once, not per k.
    const bool k2_resident = (m <= TM);

    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    if (k2_resident) {
        for (int idx = tid; idx < TM * TJ; idx += NTHREADS) {
            const int mm = idx / TJ, c = idx % TJ;
            const int gc = j0 + c;
            float v = 0.f;
            if (mm < m && gc < m) v = K2[(size_t)mm * ldk2 + gc];
            K2s[mm * TJ + c] = rnd<BF16>(v);
        }
    }

    for (int k0 = 0; k0 < n; k0 += TK) {
        // ---- stage R: T[k-rows, j-cols] = um_full[k-rows, :] @ K2[:, j-cols]
        float t[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) t[r][c] = 0.f;

        for (int m0 = 0; m0 < m; m0 += TM) {
            // Everyone is done with As/UMs, Ts and K2s of the previous step.
            __syncthreads();
            for (int idx = tid; idx < TK * TM; idx += NTHREADS) {
                const int r = idx / TM, mm = idx % TM;
                const int gr = k0 + r, gm = m0 + mm;
                float v = 0.f;
                if (gr < n && gm < m) v = umb[(size_t)gr * m + gm];
                UMs[mm * UM_LD + r] = rnd<BF16>(v);
            }
            if (!k2_resident) {
                for (int idx = tid; idx < TM * TJ; idx += NTHREADS) {
                    const int mm = idx / TJ, c = idx % TJ;
                    const int gm = m0 + mm, gc = j0 + c;
                    float v = 0.f;
                    if (gm < m && gc < m) v = K2[(size_t)gm * ldk2 + gc];
                    K2s[mm * TJ + c] = rnd<BF16>(v);
                }
            }
            __syncthreads();
#pragma unroll 8
            for (int mm = 0; mm < TM; ++mm) {
                const float4 a = *reinterpret_cast<const float4*>(&UMs[mm * UM_LD + 4 * ty]);
                const float4 w = *reinterpret_cast<const float4*>(&K2s[mm * TJ + 4 * tx]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) t[r][c] = fmaf(av[r], wv[c], t[r][c]);
            }
        }
        // Ts was last read before the barrier at the top of the chunk loop.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            float4 v;
            v.x = rnd<BF16>(t[r][0]);
            v.y = rnd<BF16>(t[r][1]);
            v.z = rnd<BF16>(t[r][2]);
            v.w = rnd<BF16>(t[r][3]);
            *reinterpret_cast<float4*>(&Ts[(4 * ty + r) * TJ + 4 * tx]) = v;
        }
        // UMs is free now (and Ts complete after the next barrier).
        __syncthreads();

        // ---- stage L: acc += K1_rows[i-rows, k-cols] @ T[k-rows, j-cols]
        for (int idx = tid; idx < TI * TK; idx += NTHREADS) {
            const int r = idx / TK, c = idx % TK;
            const int gr = i0 + r, gc = k0 + c;
            float v = 0.f;
            if (gr < n_local && gc < n) v = K1r[(size_t)gr * ldk1 + gc];
            As[c * AS_LD + r] = rnd<BF16>(v);
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < TK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + 8 * ty]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + 8 * ty + 4]);
            const float4 w = *reinterpret_cast<const float4*>(&Ts[kk * TJ + 4 * tx]);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
        }
    }

    // ---- epilogue: out = mask_rows * acc + noise * (mask_rows * u_rows) at the
    //      local tile (i, j)
    const float noise = *noise_ptr;
    float* outb = out + (size_t)b * local_plane;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int gr = i0 + 8 * ty + r;
        if (gr >= n_local) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int gc = j0 + 4 * tx + c;
            if (gc >= m) continue;
            const size_t o = (size_t)gr * m + gc;
            const float mk = mask_rows[o];
            outb[o] = mk * acc[r][c] + noise * (mk * rnd<BF16>(ub[o]));
        }
    }
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code of the launch
// (0 = success). Does not synchronise and allocates nothing.
extern "C" int lk_mvm_fused_rows_launch(const void* K1_rows, long long ldk1,
                                        const void* K2, long long ldk2,
                                        const void* um_full,
                                        const void* mask_rows,
                                        const void* u_rows, const void* noise,
                                        void* out, int B, int n_local, int n,
                                        int m, int bf16, void* stream) {
    if (B <= 0 || n_local <= 0 || n <= 0 || m <= 0 || n_local > n)
        return (int)cudaErrorInvalidValue;
    const long long gy = ((long long)n_local + TI - 1) / TI;
    const long long gz = ((long long)m + TJ - 1) / TJ;
    if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)B, (unsigned)gy, (unsigned)gz);
    const int smem_bytes = SMEM_FLOATS * (int)sizeof(float);
    auto kernel = bf16 ? lk_mvm_fused_rows_kernel<true>
                       : lk_mvm_fused_rows_kernel<false>;
    // More than 48 KB of dynamic shared memory has to be asked for, once per
    // kernel instantiation and device. (Two threads racing here both set the
    // same value.)
    constexpr int MAX_DEVICES = 64;
    static bool smem_set[2][MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !smem_set[bf16 != 0][dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) smem_set[bf16 != 0][dev] = true;
    }
    kernel<<<grid, NTHREADS, smem_bytes, (cudaStream_t)stream>>>(
        (const float*)K1_rows, ldk1, (const float*)K2, ldk2,
        (const float*)um_full, (const float*)mask_rows, (const float*)u_rows,
        (const float*)noise, (float*)out, n_local, n, m);
    return (int)cudaGetLastError();
}

// Human-readable name of an error code returned by lk_mvm_fused_rows_launch.
extern "C" const char* lk_mvm_fused_rows_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
