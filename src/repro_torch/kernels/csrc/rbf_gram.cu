// RBF-ARD Gram matrix for NVIDIA Hopper (sm_90a).
//
//   K[i, j] = outputscale * exp(-0.5 * max(|z1_i|^2 + |z2_j|^2 - 2 z1_i . z2_j, 0))
//
// z1 (n, d) and z2 (p, d) are the inputs already divided by the lengthscales
// (the wrapper forms z = x / l, as the reference's does), contiguous float32;
// outputscale is a scalar read through a device pointer; K (n, p) float32.
//
// Replaces the TPU kernel `rbf_gram_pallas` / `_gram_kernel` of the reference
// (src/repro/kernels/gram.py). Kept from it: the squared distance through the
// expansion |a|^2 + |b|^2 - 2 a.b, accumulated over d in chunks with both row
// norms, clamped at 0, the exp epilogue applied before the one write of K,
// so the (n, p, d) difference tensor and a separate norms / exp pass never
// exist. How it is laid out is this card's:
//
// * One block per TI x TJ output tile. The d axis, a sequential grid axis
//   carrying the sums in scratch on the TPU, is a loop inside the block: each
//   step stages a TD-wide chunk of the block's z1 rows and z2 rows in shared
//   memory; every thread accumulates a 4 x 4 micro-tile of dot products and
//   the norms of its 4 rows and 4 columns in registers (the norms from the
//   same staged values, so for z1 = z2 the diagonal's squared distance is
//   exactly 0 and K[i, i] = outputscale).
// * A thread's rows and columns are strided by 16, so each store instruction
//   of a warp writes 16 consecutive floats of two rows of K: the epilogue, the
//   kernel's only large traffic, is coalesced. Guarded loads and stores, no
//   padding copies: any n, p, d.
//
// Bound on this card: bytes. The function writes n p floats and does 2 n p d
// flops: at d = 7, 3.5 flops per byte written, far below the float32 FMA
// pipes' 20 per byte. So what matters is the write of K; the arithmetic
// (including expf) hides behind it once enough blocks are in flight.
//
// Tile sizes: TI = TJ = 64, TD = 32, 256 threads; 16.6 KB of static shared
// memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TI = 64;          // output rows per block
constexpr int TJ = 64;          // output columns per block
constexpr int TD = 32;          // chunk of d staged per step
constexpr int NTHREADS = 256;   // 16 x 16 threads
constexpr int LD = TI + 1;      // padded: the transposing stores hit distinct banks

static_assert(TI == 4 * 16 && TJ == 4 * 16, "thread mapping assumes 16 x 16 threads");
static_assert(TJ + 1 == LD, "one padded stride for both tiles");

__global__ void __launch_bounds__(NTHREADS)
rbf_gram_kernel(const float* __restrict__ z1, const float* __restrict__ z2,
                const float* __restrict__ scale_ptr, float* __restrict__ out,
                int n, int p, int d) {
    __shared__ float As[TD * LD];   // [TD][LD]  z1[i-rows, chunk], transposed
    __shared__ float Bs[TD * LD];   // [TD][LD]  z2[j-rows, chunk], transposed

    const int tid = threadIdx.x;
    const int tx = tid & 15;        // columns j0 + tx + 16 c
    const int ty = tid >> 4;        // rows    i0 + ty + 16 r
    const int j0 = blockIdx.x * TJ;
    const int i0 = blockIdx.y * TI;

    float acc[4][4], ni[4], nj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        ni[r] = 0.f;
        nj[r] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    }

    for (int d0 = 0; d0 < d; d0 += TD) {
        const int kn = min(TD, d - d0);
        // Everyone is done reading the previous chunk.
        __syncthreads();
        for (int idx = tid; idx < TI * TD; idx += NTHREADS) {
            const int r = idx / TD, kk = idx % TD;
            if (kk >= kn) continue;
            const int gr = i0 + r;
            As[kk * LD + r] = gr < n ? z1[(size_t)gr * d + d0 + kk] : 0.f;
        }
        for (int idx = tid; idx < TJ * TD; idx += NTHREADS) {
            const int c = idx / TD, kk = idx % TD;
            if (kk >= kn) continue;
            const int gc = j0 + c;
            Bs[kk * LD + c] = gc < p ? z2[(size_t)gc * d + d0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = As[kk * LD + ty + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) b[c] = Bs[kk * LD + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                ni[r] = fmaf(a[r], a[r], ni[r]);
                nj[r] = fmaf(b[r], b[r], nj[r]);
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
            }
        }
    }

    // ---- epilogue: one write of K per element
    const float scale = *scale_ptr;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int gr = i0 + ty + 16 * r;
        if (gr >= n) continue;
        float* row = out + (size_t)gr * p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int gc = j0 + tx + 16 * c;
            if (gc >= p) continue;
            const float sq = fmaxf(ni[r] + nj[c] - 2.f * acc[r][c], 0.f);
            row[gc] = scale * expf(-0.5f * sq);
        }
    }
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code of the launch
// (0 = success). Does not synchronise and allocates nothing.
extern "C" int rbf_gram_launch(const void* z1, const void* z2,
                               const void* outputscale, void* out, int n,
                               int p, int d, void* stream) {
    if (n <= 0 || p <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const long long gx = ((long long)p + TJ - 1) / TJ;
    const long long gy = ((long long)n + TI - 1) / TI;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gx, (unsigned)gy);
    rbf_gram_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)z1, (const float*)z2, (const float*)outputscale,
        (float*)out, n, p, d);
    return (int)cudaGetLastError();
}

// Human-readable name of an error code returned by rbf_gram_launch.
extern "C" const char* rbf_gram_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
