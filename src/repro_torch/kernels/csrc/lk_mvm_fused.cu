// Fused masked latent-Kronecker matrix-vector product for NVIDIA Hopper (sm_90a).
//
//   out[b] = mask * (K1 @ ((mask * U[b]) @ K2)) + noise * (mask * U[b])
//
// K1 (n, n), K2 (m, m), mask (n, m) of 0/1 floats, U and out (B, n, m), noise
// a scalar read through a device pointer. All float32.
//
// Replaces the TPU kernel `lk_mvm_fused` / `_fused_kernel` of the reference
// (src/repro/kernels/lk_mvm.py). What is kept from it is WHAT it computes and
// what it keeps out of device memory: the (B, n, m) intermediate
// T = (mask * U) @ K2 is never written to device memory. How it is laid out is
// this card's:
//
// * One thread block owns one output tile (b, i, j) of TI x TJ elements and
//   loops over the K1 column blocks k itself (the reference carries the sum
//   across sequential grid steps, which parallel blocks cannot do). Per k it
//   forms T[k, j] = (mask * U)[b, k-rows, :] @ K2[:, j-cols] in shared memory,
//   sweeping m in chunks of TM so that no "row strip must fit" limit exists,
//   and then accumulates K1[i, k] @ T[k, j] in registers.
// * The mask/U tile of the epilogue is loaded directly at (i, j); the
//   reference's capture at k == i is an artefact of its sweep order.
// * No host-side zero padding: the kernel takes n, m, B and the row strides
//   of K1 and K2 and guards every ragged edge itself. All global accesses are
//   scalar (4 bytes a thread, neighbouring threads on neighbouring
//   addresses), so rows of e.g. m = 50 or 52 floats need no alignment.
// * precision = bf16: K1, K2, U and the intermediate T are rounded to
//   bfloat16 where they enter shared memory; products accumulate in float32;
//   the mask/noise epilogue is float32. This version still multiplies with
//   FMAs in both modes (no tensor cores yet), so bf16 changes the rounding,
//   not the speed.
//
// Tile sizes: TI = 128, TJ = 64, TK = 64, TM = 64, 256 threads. A thread holds
// an 8 x 4 micro-tile of the output and a 4 x 4 micro-tile of T. T is
// recomputed by every row block i, so the first product is done n / TI times
// over; measured against the main product that is m / TI extra work (0.5 at
// m = 64, 0.41 at m = 52). The grid has B * ceil(n / TI) * ceil(m / TJ) blocks
// with b fastest, so blocks that run together share one K1 row strip in L2;
// at B = 1, n = 2000, m = 52 that is only 16 blocks for 132 SMs.
//
// Bound on this card: operations, not bytes. The function needs
// 2 B (n^2 m + n m^2) flops against 4 (n^2 + m^2 + nm + 2 B nm) bytes; at
// (B, n, m) = (65, 8192, 64) that is about 1000 flops per byte. The float32
// FMA pipes are therefore the limit of this design; the tensor cores (wgmma on
// bf16/tf32 operands, tiles brought in by TMA) are the way past it.
//
// Shared memory: 65 KB dynamic (K1 tile, which also hosts the (mask * U) chunk,
// + T tile + K2 chunk), so up to three blocks share an SM and one block's
// loads overlap another's arithmetic; there is no software pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TI = 128;        // output rows per block
constexpr int TJ = 64;         // output columns per block
constexpr int TK = 64;         // K1 columns (= rows of T) per sweep step
constexpr int TM = 64;         // chunk of the inner dimension of (mask*U) @ K2
constexpr int NTHREADS = 256;  // 16 x 16 threads
constexpr int AS_LD = TI + 4;  // K1 tile, stored transposed [TK][AS_LD]
constexpr int UM_LD = TK + 4;  // (mask*U) chunk, stored transposed [TM][UM_LD]
constexpr int SMEM_FLOATS = TK * AS_LD + TK * TJ + TM * TJ;

static_assert(TM * UM_LD <= TK * AS_LD, "(mask*U) chunk must fit in the K1 tile's space");
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
lk_mvm_fused_kernel(const float* __restrict__ K1, long long ldk1,
                    const float* __restrict__ K2, long long ldk2,
                    const float* __restrict__ mask,
                    const float* __restrict__ U,
                    const float* __restrict__ noise_ptr,
                    float* __restrict__ out, int n, int m) {
    extern __shared__ __align__(16) float smem[];
    float* As = smem;                  // [TK][AS_LD]  K1[i-rows, k-cols], transposed
    float* UMs = smem;                 // [TM][UM_LD]  (mask*U)[k-rows, chunk], transposed;
                                       //              lives in As's space between uses
    float* Ts = smem + TK * AS_LD;     // [TK][TJ]     T[k-rows, j-cols]
    float* K2s = Ts + TK * TJ;         // [TM][TJ]     K2[chunk, j-cols]

    const int tid = threadIdx.x;
    const int tx = tid & 15;           // column group: columns 4*tx .. 4*tx+3
    const int ty = tid >> 4;           // row group
    const int b = blockIdx.x;
    const int i0 = blockIdx.y * TI;
    const int j0 = blockIdx.z * TJ;
    const size_t plane = (size_t)n * (size_t)m;
    const float* Ub = U + (size_t)b * plane;
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
        // ---- stage R: T[k-rows, j-cols] = (mask*U)[k-rows, :] @ K2[:, j-cols]
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
                if (gr < n && gm < m) {
                    const size_t o = (size_t)gr * m + gm;
                    v = mask[o] * Ub[o];
                }
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

        // ---- stage L: acc += K1[i-rows, k-cols] @ T[k-rows, j-cols]
        for (int idx = tid; idx < TI * TK; idx += NTHREADS) {
            const int r = idx / TK, c = idx % TK;
            const int gr = i0 + r, gc = k0 + c;
            float v = 0.f;
            if (gr < n && gc < n) v = K1[(size_t)gr * ldk1 + gc];
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

    // ---- epilogue: out = mask * acc + noise * (mask * U) at tile (i, j)
    const float noise = *noise_ptr;
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
            outb[o] = mk * acc[r][c] + noise * (mk * rnd<BF16>(Ub[o]));
        }
    }
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code of the launch
// (0 = success). Does not synchronise and allocates nothing.
extern "C" int lk_mvm_fused_launch(const void* K1, long long ldk1,
                                   const void* K2, long long ldk2,
                                   const void* mask, const void* U,
                                   const void* noise, void* out,
                                   int B, int n, int m, int bf16,
                                   void* stream) {
    if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const long long gy = ((long long)n + TI - 1) / TI;
    const long long gz = ((long long)m + TJ - 1) / TJ;
    if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)B, (unsigned)gy, (unsigned)gz);
    const int smem_bytes = SMEM_FLOATS * (int)sizeof(float);
    auto kernel = bf16 ? lk_mvm_fused_kernel<true> : lk_mvm_fused_kernel<false>;
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
        (const float*)K1, ldk1, (const float*)K2, ldk2, (const float*)mask,
        (const float*)U, (const float*)noise, (float*)out, n, m);
    return (int)cudaGetLastError();
}

// Human-readable name of an error code returned by lk_mvm_fused_launch.
extern "C" const char* lk_mvm_fused_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
