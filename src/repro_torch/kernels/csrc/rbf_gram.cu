// RBF-ARD Gram matrix for NVIDIA Hopper (sm_90a), kernel K4.
//
//   K[i, j] = outputscale * exp(-0.5 * max(|z1_i|^2 + |z2_j|^2 - 2 z1_i . z2_j, 0))
//   z = x / l
//
// x1 (n, d) and x2 (p, d) contiguous, in the division's dtype TX (float or
// double) with the lengthscales l (d,) in the same dtype; outputscale a
// float32 scalar read through a device pointer; K (n, p) in the caller's
// dtype TO (float or double).
//
// Replaces the TPU kernel `rbf_gram_pallas` / `_gram_kernel` of the reference
// (src/repro/kernels/gram.py). Kept from it: the squared distance through the
// expansion |a|^2 + |b|^2 - 2 a.b in float32, clamped at 0, the exp epilogue
// applied before the one write of K, and the output written in x1's dtype
// from the epilogue (the reference's `.astype(o_ref.dtype)`): computed in
// float32, then converted. The division z = x / l happens where x is loaded,
// in TX with IEEE division (no fast math), then rounded to float32: the bits
// of `(x / l).to(float32)`. (A float32 x divided in double and rounded to
// float32 gives the bits of the float32 division: double carries more than
// twice float32's precision, so the double rounding is innocuous.)
//
// Bound on this card: bytes, and the bytes are the stores. The function
// writes n p values and does 2 n p d flops: at d = 7 and a float32 K that is
// 3.5 flops per byte written, far below the FMA pipes' 20. The design is
// about getting the stores out at full width with the arithmetic hidden
// behind them:
//
// * Persistent warps. The grid is `blocks` = k x SMs blocks of 8 warps (k
//   from the budget model, kernels/budget.py). The output is cut into
//   column tiles of 128 columns and each column tile into `row_chunks`
//   ranges of rows; a unit is one (column tile, row range), and warp w of
//   the grid takes units w, w + 8 blocks, ... (the planner makes the units
//   about one per warp). A warp loads the z2 rows of its 128 columns (4 a
//   lane) and their norms ONCE per unit into registers, and walks the rows
//   of its range: the column norms are never computed again.
// * The z1 rows are staged 32 at a time in the warp's own slice of shared
//   memory: lane l divides and rounds row rb + l and sums its norm, so each
//   row's z and norm are formed once per unit; then every lane reads a row as
//   16-byte broadcasts. __syncwarp only: no block-wide barrier anywhere.
// * Stores at full width: lane l writes columns [4 l, 4 l + 4) of the column
//   tile (float, one 16-byte store) or [2 l, 2 l + 2) and [64 + 2 l, 64 + 2 l
//   + 2) (double, two 16-byte stores), so each store instruction of a warp
//   writes 512 contiguous bytes, with the streaming hint (st.global.cs: K is
//   far larger than the 50 MB L2 and is not read back here). A p whose rows
//   are not 16-byte aligned, and the ragged last column tile, take scalar
//   streaming stores.
// * exp(-sq / 2) as exp2f(c sq) with c = -log2(e) / 2 folded into one
//   constant.
// * d <= 8 and d <= 16 keep all of d in registers (z2: 4 x 8 or 4 x 16
//   floats a lane, zero-padded: fmaf(0, 0, s) = s leaves every sum's bits
//   alone); d > 16 sweeps d in chunks of 16, reloading the z2 chunk per row
//   (not a shape of the main path). The dot products and the norms are summed
//   in the same order (k ascending, one fmaf each), so for z1_i = z2_j the
//   squared distance is exactly 0 and K[i, j] = outputscale. Nothing is
//   summed across threads or blocks: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "kernel_attr.cuh"

namespace rbf {

constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
constexpr int CPL = 4;              // output columns per lane
constexpr int TJ = 32 * CPL;        // columns of a column tile: one warp's
constexpr int RB = 32;              // z1 rows a warp stages at a time
constexpr int DK_SMALL = 8;         // d kept in registers
constexpr int DK_LARGE = 16;        // ... and the chunk of d beyond it
constexpr float EXP2_SCALE = -0.72134752044448170368f;   // -log2(e) / 2

// The instantiations along d: all of d in registers (SMALL: d <= 8, LARGE:
// d <= 16), or swept in chunks of DK_LARGE (CHUNKED).
enum Variant { SMALL = 0, LARGE = 1, CHUNKED = 2, VARIANTS = 3 };

template <int V> struct Shape {
    static constexpr int DK = V == SMALL ? DK_SMALL : DK_LARGE;
    static constexpr bool ONE_CHUNK = V != CHUNKED;
    static constexpr int LDS = DK + 4;   // a staged row: DK values, the norm, padding to 16 B
    // __launch_bounds__ minimum blocks per SM: 80 registers a thread for
    // SMALL, 128 for the others.
    static constexpr int MIN_BLOCKS = V == SMALL ? 3 : 2;
    static constexpr int SMEM = WARPS * RB * LDS * (int)sizeof(float);
};

// The grid, decided on the host by the wrapper's planner (kernels/gram.py:
// plan_gram) and launched as it is: col_tiles column tiles of TJ columns,
// each cut into row_chunks ranges of rows (range q: [q n / R, (q + 1) n / R)),
// walked by the 8 warps of each of `blocks` blocks.
struct GramPlan {
    int col_tiles, row_chunks, blocks;
};

template <typename TX>
__device__ __forceinline__ float scaled(const TX* __restrict__ x,
                                        const TX* __restrict__ l, size_t i, int k) {
    return (float)(x[i] / l[k]);
}

// One 16-byte streaming store of VW = 16 / sizeof(TO) values.
__device__ __forceinline__ void store16(float* dst, const float* v) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(double* dst, const float* v) {
    __stcs(reinterpret_cast<double2*>(dst), make_double2((double)v[0], (double)v[1]));
}

template <typename TX, typename TO, int V>
__global__ void __launch_bounds__(NTHREADS, Shape<V>::MIN_BLOCKS)
rbf_gram_kernel(const void* __restrict__ x1_, const void* __restrict__ x2_,
                const void* __restrict__ ls_, const float* __restrict__ scale_ptr,
                void* __restrict__ out_, int n, int p, int d, GramPlan plan,
                int vec) {
    using S = Shape<V>;
    constexpr int DK = S::DK, LDS = S::LDS;
    constexpr int VW = 16 / (int)sizeof(TO);   // columns per 16-byte store
    constexpr int G = CPL / VW;                 // 16-byte stores per lane and row
    const TX* __restrict__ x1 = (const TX*)x1_;
    const TX* __restrict__ x2 = (const TX*)x2_;
    const TX* __restrict__ ls = (const TX*)ls_;
    TO* __restrict__ out = (TO*)out_;
    __shared__ __align__(16) float stage[WARPS * RB * LDS];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* const zs = stage + warp * RB * LDS;   // [RB][LDS]: this warp's rows
    const float scale = *scale_ptr;
    const long long units = (long long)plan.col_tiles * plan.row_chunks;
    const long long step = (long long)plan.blocks * WARPS;

    for (long long u = (long long)blockIdx.x * WARPS + warp; u < units; u += step) {
        const int c = (int)(u / plan.row_chunks);
        const int q = (int)(u - (long long)c * plan.row_chunks);
        const int r_begin = (int)((long long)q * n / plan.row_chunks);
        const int r_end = (int)((long long)(q + 1) * n / plan.row_chunks);

        // The lane's columns: store g writes col[g VW .. g VW + VW).
        int col[CPL];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int v = 0; v < VW; ++v)
                col[g * VW + v] = c * TJ + g * 32 * VW + lane * VW + v;

        // z2 of those columns (all of d in the one-chunk variants) and their
        // norms, once per unit.
        float b[CPL][S::ONE_CHUNK ? DK : 1];
        float n2[CPL];
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
            n2[t] = 0.f;
            const bool ok = col[t] < p;
            const size_t base = (size_t)col[t] * d;
            if constexpr (S::ONE_CHUNK) {
#pragma unroll
                for (int k = 0; k < DK; ++k) {
                    b[t][k] = ok && k < d ? scaled(x2, ls, base + k, k) : 0.f;
                    n2[t] = fmaf(b[t][k], b[t][k], n2[t]);
                }
            } else if (ok) {
                for (int k = 0; k < d; ++k) {
                    const float z = scaled(x2, ls, base + k, k);
                    n2[t] = fmaf(z, z, n2[t]);
                }
            }
        }

        for (int rb = r_begin; rb < r_end; rb += RB) {
            const int rows = min(RB, r_end - rb);
            __syncwarp();   // every lane is done with the previous batch
            if (lane < rows) {
                const size_t base = (size_t)(rb + lane) * d;
                float n1 = 0.f;
                if constexpr (S::ONE_CHUNK) {
#pragma unroll
                    for (int k = 0; k < DK; ++k) {
                        const float z = k < d ? scaled(x1, ls, base + k, k) : 0.f;
                        zs[lane * LDS + k] = z;
                        n1 = fmaf(z, z, n1);
                    }
                } else {
                    for (int k = 0; k < d; ++k) {
                        const float z = scaled(x1, ls, base + k, k);
                        n1 = fmaf(z, z, n1);
                    }
                }
                zs[lane * LDS + DK] = n1;
            }
            __syncwarp();

            for (int r = 0; r < rows; ++r) {
                const int i = rb + r;
                const float* zr = zs + r * LDS;
                float acc[CPL];
#pragma unroll
                for (int t = 0; t < CPL; ++t) acc[t] = 0.f;
                if constexpr (S::ONE_CHUNK) {
                    float a[DK];
#pragma unroll
                    for (int k = 0; k < DK; k += 4) {
                        const float4 v = *reinterpret_cast<const float4*>(zr + k);
                        a[k] = v.x; a[k + 1] = v.y; a[k + 2] = v.z; a[k + 3] = v.w;
                    }
#pragma unroll
                    for (int k = 0; k < DK; ++k)
#pragma unroll
                        for (int t = 0; t < CPL; ++t)
                            acc[t] = fmaf(a[k], b[t][k], acc[t]);
                } else {
                    const size_t base = (size_t)i * d;
                    for (int k0 = 0; k0 < d; k0 += DK) {
                        float a[DK];
#pragma unroll
                        for (int k = 0; k < DK; ++k)
                            a[k] = k0 + k < d ? scaled(x1, ls, base + k0 + k, k0 + k) : 0.f;
#pragma unroll
                        for (int t = 0; t < CPL; ++t) {
                            const size_t cb = (size_t)col[t] * d + k0;
#pragma unroll
                            for (int k = 0; k < DK; ++k) {
                                const float z = col[t] < p && k0 + k < d
                                                    ? scaled(x2, ls, cb + k, k0 + k) : 0.f;
                                acc[t] = fmaf(a[k], z, acc[t]);
                            }
                        }
                    }
                }
                const float n1 = zr[DK];
                float o[CPL];
#pragma unroll
                for (int t = 0; t < CPL; ++t)
                    o[t] = scale * exp2f(EXP2_SCALE * fmaxf(n1 + n2[t] - 2.f * acc[t], 0.f));
                TO* row = out + (size_t)i * p;
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const int j = col[g * VW];
                    if (vec && j + VW <= p) {
                        store16(row + j, o + g * VW);
                    } else {
#pragma unroll
                        for (int v = 0; v < VW; ++v)
                            if (j + v < p) __stcs(row + j + v, (TO)o[g * VW + v]);
                    }
                }
            }
        }
    }
}

using Kernel = void (*)(const void*, const void*, const void*, const float*, void*,
                        int, int, int, GramPlan, int);

// Instantiation `which` = (TX is double) * 6 + (TO is double) * 3 + variant:
// the order of kernels/budget.py's K4 entries.
constexpr int INSTANTIATIONS = 4 * VARIANTS;
const Kernel KERNELS[INSTANTIATIONS] = {
    rbf_gram_kernel<float, float, SMALL>, rbf_gram_kernel<float, float, LARGE>,
    rbf_gram_kernel<float, float, CHUNKED>,
    rbf_gram_kernel<float, double, SMALL>, rbf_gram_kernel<float, double, LARGE>,
    rbf_gram_kernel<float, double, CHUNKED>,
    rbf_gram_kernel<double, float, SMALL>, rbf_gram_kernel<double, float, LARGE>,
    rbf_gram_kernel<double, float, CHUNKED>,
    rbf_gram_kernel<double, double, SMALL>, rbf_gram_kernel<double, double, LARGE>,
    rbf_gram_kernel<double, double, CHUNKED>,
};

}  // namespace rbf

// Launches the kernel on `stream` with the grid of `plan` (the wrapper's
// planner). x1, x2 and ls are float (x_double = 0) or double; out is float
// (out_double = 0) or double. Returns the CUDA error code of the launch
// (0 = success; cudaErrorInvalidValue for a plan that does not cover the
// columns). Does not synchronise and allocates nothing.
extern "C" int rbf_gram_launch(const void* x1, const void* x2, const void* ls,
                               int x_double, const void* outputscale, void* out,
                               int out_double, int n, int p, int d,
                               const rbf::GramPlan* plan, void* stream) {
    using namespace rbf;
    if (n <= 0 || p <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    if ((long long)plan->col_tiles != ((long long)p + TJ - 1) / TJ
        || plan->row_chunks < 1 || plan->blocks < 1)
        return (int)cudaErrorInvalidValue;
    const int variant = d <= DK_SMALL ? SMALL : d <= DK_LARGE ? LARGE : CHUNKED;
    const Kernel kernel = KERNELS[(x_double ? 6 : 0) + (out_double ? 3 : 0) + variant];
    const size_t item = out_double ? sizeof(double) : sizeof(float);
    const int vec = (uintptr_t)out % 16 == 0 && (size_t)p * item % 16 == 0;
    kernel<<<plan->blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
        x1, x2, ls, (const float*)outputscale, out, n, p, d, *plan, vec);
    return (int)cudaGetLastError();
}

// The runtime's view of instantiation `which` (see KERNELS) at its launch.
extern "C" int rbf_gram_attributes(int which, KernelAttr* out) {
    using namespace rbf;
    if (which < 0 || which >= INSTANTIATIONS) return (int)cudaErrorInvalidValue;
    return kernel_attributes(KERNELS[which], NTHREADS, 0, out);
}

// Human-readable name of an error code returned by the entry points.
extern "C" const char* rbf_gram_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
