// Stage L of the two-stage masked latent-Kronecker MVM (kernel K2b) for
// NVIDIA Hopper (sm_90a):
//
//   out[b, i, j] = mask[i, j] * sum_k K1[i, k] T[b, k, j]
//                  + noise * (mask[i, j] * U[b, i, j])
//
// Replaces the TPU kernel `_stage_left_kernel` of `lk_mvm_two_stage` in the
// reference (src/repro/kernels/lk_mvm.py). The reference accumulates over its
// innermost grid axis in a scratch tile on one core; here a persistent block
// walks whole output tiles and loops over k itself.
//
// Operands, split once before the kernel runs: K1 as (K1_hi, K1_lo) and T
// transposed as (T_hi, T_lo), every value exactly representable in TF32
// (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); K1 once per K1 tensor by
// the wrapper, T by kernel K2a as it writes it). The planes are K-major: K1's
// rows (n, ldk) and T^T's rows (B m, ldt), one row per flattened (b, j)
// column, so the batch needs no padding per member. A product is lo*hi +
// hi*lo + hi*hi on the tensor cores (3xTF32): about 21 bits of each operand,
// where one TF32 pass keeps 11 and misses the 1e-4 check against float64.
//
// What bounds it on this card: operations. At (65, 4096, 52) the 3xTF32
// product is 3 x 2 n^2 B m = 0.34 TFLOP against 0.2 GB of operands, far
// above the ridge. The design is the one that reaches the tensor cores' rate:
// * wgmma (m64nBNk8, TF32) from shared memory: two consumer warpgroups, 64
//   output rows each, share a BN-column tile of T^T (BN = 128, or 64 when
//   B m <= 64).
// * TMA loads, 128-byte swizzled, into a three-stage ring of (K1_hi, K1_lo,
//   T_hi, T_lo) k tiles of BK = 32, issued by one producer thread and
//   completed on mbarriers; the consumers release a stage as soon as its
//   wgmmas retire. Past the edges (rows >= n, columns >= B m, k >= n) TMA
//   fills zeros, so ragged shapes need no padding copies.
// * Persistent: one block an SM walks (row tile, column tile, split) units
//   in groups of GROUP row tiles, so that the tiles in flight share K1's and
//   T's panels in L2. The plan (tile width, split of k) comes from the
//   wrapper's planner (kernels/lk_mvm.py: plan_stage_left), which splits k
//   only when the tiles would leave half the card idle (B = 1).
// * Truncation: the tensor cores' float32 accumulation truncates. The
//   wgmmas of PROMOTE = 2 k steps (the four lo products first, then the two
//   hi*hi, so the running value stays small while the small terms go in)
//   chain into a zeroed accumulator, which a rounding float32 FADD adds to
//   the output tile; two such chains a k tile. The order
//   tests/test_torch_kernels.py emulates at n = 4096: a chain of a whole k
//   tile (4 steps) doubles the bias toward zero of one step's chain, which
//   CG solutions amplify; 2 steps keep it within 1.5x.
// * Split k: each split writes its partial tile to a workspace; a second
//   kernel sums the splits in order and applies the epilogue. No atomics:
//   the same inputs give the same bits.
// The epilogue reads the mask, U and the noise (through its device pointer)
// and writes out (B, n, m) from the accumulator registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "kernel_attr.cuh"

namespace lk_wg {

constexpr int BM = 128;          // output rows per tile: two warpgroups of 64
constexpr int BK = 32;           // k per stage: one 128-byte swizzle row of float32
constexpr int STAGES = 3;        // depth of the TMA ring
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int NTHREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int MAX_SPLITS = 8;
constexpr int GROUP = 8;         // row tiles a raster group walks column by column
constexpr int PROMOTE = 2;       // k steps of 8 chained in the tensor cores before a FADD
constexpr int SUM_THREADS = 256; // the split sum's block

template <int BN> struct Smem {
    static constexpr int A_BYTES = BM * BK * 4;     // one plane of K1's k tile
    static constexpr int B_BYTES = BN * BK * 4;     // one plane of T^T's k tile
    static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
    // the ring, the barriers, and room to align the ring to 1024 bytes (the
    // 128-byte swizzle's period)
    static constexpr int BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
    static_assert(BYTES <= 232448, "more shared memory than a block may have");
};

// The launch plan, decided on the host by the wrapper's planner
// (kernels/lk_mvm.py: plan_stage_left) and launched as it is: row_tiles x
// col_tiles output tiles of BM rows by col_tile flattened (b, j) columns,
// each summed by `splits` units over k_tiles tiles of BK; `blocks`
// persistent blocks walk the units.
struct Plan {
    int row_tiles, col_tiles, col_tile, k_tiles, splits, blocks;
};

struct Args {
    const float* mask;    // (n, m)
    const float* u;       // (B, n, m)
    const float* noise;   // device scalar
    float* out;           // (B, n, m)
    float* work;          // (splits, n, B m) when splits > 1
    int B, n, m;
    Plan plan;
};

// Unit q of the plan: (row tile, column tile, split) and the split's k tiles
// [kb, ke). Units of one tile are consecutive; tiles go GROUP row tiles at a
// time, column tile by column tile (the planner's schedule() mirrors this).
__device__ __forceinline__ void unit(int q, const Plan& p, int& rt, int& ct, int& kb,
                                     int& ke) {
    const int s = q % p.splits, t = q / p.splits;
    const int per_group = GROUP * p.col_tiles;
    const int g = t / per_group, w = t - g * per_group;
    const int rows = min(GROUP, p.row_tiles - g * GROUP);
    rt = g * GROUP + w % rows;
    ct = w / rows;
    kb = (int)((long long)s * p.k_tiles / p.splits);
    ke = (int)((long long)(s + 1) * p.k_tiles / p.splits);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)),
                 "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar))
                 : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// One 2-D TMA load of a box at (inner c0, outer c1) into shared memory,
// its bytes completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)   // start address
           | ((uint64_t)1 << 16)                // leading offset (unused when swizzled)
           | ((uint64_t)(1024 >> 4) << 32)      // stride between 8-row groups
           | ((uint64_t)1 << 62);               // 128-byte swizzle
}

template <int N> struct Mma;
// D (64 x N, float32) = A (64 x 8) * B (N x 8)^T, TF32 from shared memory;
// scale_d = 0 ignores D's old value.
template <> struct Mma<128> {
    __device__ static __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <> struct Mma<64> {
    __device__ static __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
    }
};

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmmas.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
lk_mvm_tc_kernel_wgmma(const __grid_constant__ CUtensorMap a_hi,
                       const __grid_constant__ CUtensorMap a_lo,
                       const __grid_constant__ CUtensorMap b_hi,
                       const __grid_constant__ CUtensorMap b_lo, const Args p) {
    using S = Smem<BN>;
    constexpr int R = BN / 2;   // accumulator registers a thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* const ring = reinterpret_cast<unsigned char*>(
        ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
    uint64_t* const full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE_BYTES);
    uint64_t* const empty = full + STAGES;
    auto A_hi = [&](int s) { return ring + s * S::STAGE_BYTES; };
    auto A_lo = [&](int s) { return A_hi(s) + S::A_BYTES; };
    auto B_hi = [&](int s) { return A_lo(s) + S::A_BYTES; };
    auto B_lo = [&](int s) { return B_hi(s) + S::B_BYTES; };

    const Plan& q = p.plan;
    const int units = q.row_tiles * q.col_tiles * q.splits;
    const int wg = threadIdx.x / 128;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS * 4);   // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // ---- producer: one thread keeps the ring full
        if (threadIdx.x != CONSUMERS * 128) return;
        int s = 0;
        uint32_t phase = 0;
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            int rt, ct, kb, ke;
            unit(u, q, rt, ct, kb, ke);
            for (int kt = kb; kt < ke; ++kt) {
                mbar_wait(&empty[s], phase ^ 1);
                mbar_expect_tx(&full[s], S::STAGE_BYTES);
                tma_load(A_hi(s), &a_hi, &full[s], kt * BK, rt * BM);
                tma_load(A_lo(s), &a_lo, &full[s], kt * BK, rt * BM);
                tma_load(B_hi(s), &b_hi, &full[s], kt * BK, ct * BN);
                tma_load(B_lo(s), &b_lo, &full[s], kt * BK, ct * BN);
                if (++s == STAGES) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of a tile
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const uint32_t a_off = wg * 64 * BK * 4;   // this warpgroup's 64 rows of K1's tile
    float acc[R], part[R];
#pragma unroll
    for (int i = 0; i < R; ++i) part[i] = 0.f;
    const float noise = *p.noise;
    const int n = p.n, m = p.m, N = p.B * p.m;
    int s = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int rt, ct, kb, ke;
        unit(u, q, rt, ct, kb, ke);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0.f;
        for (int kt = kb; kt < ke; ++kt) {
            mbar_wait(&full[s], phase);
            const uint64_t ah = desc_sw128(smem_u32(A_hi(s)) + a_off);
            const uint64_t al = desc_sw128(smem_u32(A_lo(s)) + a_off);
            const uint64_t bh = desc_sw128(smem_u32(B_hi(s)));
            const uint64_t bl = desc_sw128(smem_u32(B_lo(s)));
            // PROMOTE k steps a chain; k step ks reads 32 bytes further
            // along each 128-byte row: +2 in the descriptor's 16-byte units
#pragma unroll
            for (int c = 0; c < BK / 8 / PROMOTE; ++c) {
                fence_regs(part);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                for (int h = 0; h < PROMOTE; ++h) {
                    const int ks = c * PROMOTE + h;
                    Mma<BN>::run(part, al + 2 * ks, bh + 2 * ks, h > 0);
                    Mma<BN>::run(part, ah + 2 * ks, bl + 2 * ks, 1);
                }
#pragma unroll
                for (int h = 0; h < PROMOTE; ++h) {
                    const int ks = c * PROMOTE + h;
                    Mma<BN>::run(part, ah + 2 * ks, bh + 2 * ks, 1);
                }
                asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
                fence_regs(part);
                if (c == BK / 8 / PROMOTE - 1 && lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
                for (int i = 0; i < R; ++i) acc[i] += part[i];
            }
            if (++s == STAGES) {
                s = 0;
                phase ^= 1;
            }
        }

        // ---- epilogue: register i holds row 16 warp + lane / 4 + 8 ((i / 2) % 2)
        //      and column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's tile
        const int row0 = rt * BM + wg * 64 + warp * 16 + (lane >> 2);
        const int col0 = ct * BN + 2 * (lane & 3);
        const int split = u % q.splits;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int row = row0 + 8 * ((i >> 1) & 1);
            const int c = col0 + 8 * (i >> 2) + (i & 1);
            if (row >= n || c >= N) continue;
            if (q.splits > 1) {
                p.work[((size_t)split * n + row) * (size_t)N + c] = acc[i];
            } else {
                const int b = c / m, j = c - b * m;
                const size_t o = (size_t)row * m + j;
                const size_t ob = (size_t)b * n * m + o;
                const float mk = p.mask[o];
                p.out[ob] = mk * acc[i] + noise * (mk * p.u[ob]);
            }
        }
    }
}

// The splits' partial tiles summed in split order, then the epilogue.
__global__ void __launch_bounds__(SUM_THREADS)
lk_mvm_tc_kernel_split_sum(const float* __restrict__ work, int splits,
                           const float* __restrict__ mask, const float* __restrict__ u,
                           const float* __restrict__ noise, float* __restrict__ out,
                           int B, int n, int m) {
    const float nz = *noise;
    const long long total = (long long)B * n * m, N = (long long)B * m;
    const long long plane = (long long)n * N;
    for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < total;
         o += (long long)gridDim.x * blockDim.x) {
        const int j = (int)(o % m);
        const long long bi = o / m;
        const int i = (int)(bi % n), b = (int)(bi / n);
        const long long c = (long long)b * m + j;
        float acc = 0.f;
        for (int r = 0; r < splits; ++r) acc += work[r * plane + (long long)i * N + c];
        const float mk = mask[(long long)i * m + j];
        out[o] = mk * acc + nz * (mk * u[o]);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, looked up through the
// runtime (no link to libcuda); null where the installed libcuda lacks it.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                    &found) == cudaSuccess
            && found == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)ptr;
    }
    return fn;
}

// A (rows, cols) float32 plane with row stride ld, read in boxes of BK x box_rows,
// 128-byte swizzled, zero past its edges.
inline int plane_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                     long long ld, int box_rows) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
                           dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN>
inline int launch(const CUtensorMap (&maps)[4], const Args& p, cudaStream_t stream) {
    // More than 48 KB of dynamic shared memory has to be asked for, once per
    // instantiation and device. (Two threads racing here set the same value.)
    constexpr int MAX_DEVICES = 64;
    static bool smem_set[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !smem_set[dev]) {
        err = cudaFuncSetAttribute(lk_mvm_tc_kernel_wgmma<BN>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Smem<BN>::BYTES);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) smem_set[dev] = true;
    }
    lk_mvm_tc_kernel_wgmma<BN><<<p.plan.blocks, NTHREADS, Smem<BN>::BYTES, stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
    return (int)cudaGetLastError();
}

}  // namespace lk_wg

// Launches K2b on `stream` with the plan of the wrapper's planner: K1's planes
// (n, ldk), T^T's planes (B m, ldt), every plane 16-byte aligned with
// ld % 4 == 0 and ld >= n; mask (n, m), U and out (B, n, m) contiguous; noise
// a device scalar; `work` (splits, n, B m) when the plan splits k, else
// unused. Returns the CUDA error code (0 = success; cudaErrorInvalidValue for
// a plan that does not cover the output or operands TMA cannot read). Does
// not synchronise and allocates nothing.
extern "C" int lk_mvm_stage_left_launch(const void* K1_hi, const void* K1_lo,
                                        long long ldk, const void* T_hi,
                                        const void* T_lo, long long ldt,
                                        const void* mask, const void* U,
                                        const void* noise, void* out, void* work,
                                        int B, int n, int m, const lk_wg::Plan* plan,
                                        void* stream) {
    using namespace lk_wg;
    if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
    const long long N = (long long)B * m;
    const Plan& q = *plan;
    if ((q.col_tile != 64 && q.col_tile != 128)
        || (long long)q.row_tiles != ((long long)n + BM - 1) / BM
        || (long long)q.col_tiles != (N + q.col_tile - 1) / q.col_tile
        || (long long)q.k_tiles != ((long long)n + BK - 1) / BK
        || q.splits < 1 || q.splits > MAX_SPLITS || q.splits > q.k_tiles
        || q.blocks < 1
        || (long long)q.blocks > (long long)q.row_tiles * q.col_tiles * q.splits
        || (long long)q.row_tiles * q.col_tiles * q.splits >= (1LL << 31)
        || (q.splits > 1 && work == nullptr))
        return (int)cudaErrorInvalidValue;
    const uintptr_t ptrs = (uintptr_t)K1_hi | (uintptr_t)K1_lo | (uintptr_t)T_hi
                           | (uintptr_t)T_lo;
    if (ptrs % 16 != 0 || ldk % 4 != 0 || ldt % 4 != 0 || ldk < n || ldt < n)
        return (int)cudaErrorInvalidValue;
    CUtensorMap maps[4];
    int rc;
    if ((rc = plane_map(&maps[0], K1_hi, n, n, ldk, BM)) != 0) return rc;
    if ((rc = plane_map(&maps[1], K1_lo, n, n, ldk, BM)) != 0) return rc;
    if ((rc = plane_map(&maps[2], T_hi, N, n, ldt, q.col_tile)) != 0) return rc;
    if ((rc = plane_map(&maps[3], T_lo, N, n, ldt, q.col_tile)) != 0) return rc;
    Args p;
    p.mask = (const float*)mask;
    p.u = (const float*)U;
    p.noise = (const float*)noise;
    p.out = (float*)out;
    p.work = (float*)work;
    p.B = B;
    p.n = n;
    p.m = m;
    p.plan = q;
    cudaStream_t st = (cudaStream_t)stream;
    rc = q.col_tile == 128 ? launch<128>(maps, p, st) : launch<64>(maps, p, st);
    if (rc != 0 || q.splits == 1) return rc;
    const long long total = N * n;
    const long long want = (total + SUM_THREADS - 1) / SUM_THREADS;
    const int blocks = (int)(want < 65535 ? want : 65535);
    lk_mvm_tc_kernel_split_sum<<<blocks, SUM_THREADS, 0, st>>>(
        (const float*)work, q.splits, p.mask, p.u, p.noise, p.out, B, n, m);
    return (int)cudaGetLastError();
}

// The runtime's view of the instantiations the launcher picks from, at their
// launch: which = 0 the 128-column tile, 1 the 64-column tile (the order of
// kernels/budget.py's entries).
extern "C" int lk_mvm_stage_left_attributes(int which, KernelAttr* out) {
    using namespace lk_wg;
    switch (which) {
    case 0: return kernel_attributes(lk_mvm_tc_kernel_wgmma<128>, NTHREADS,
                                     Smem<128>::BYTES, out);
    case 1: return kernel_attributes(lk_mvm_tc_kernel_wgmma<64>, NTHREADS,
                                     Smem<64>::BYTES, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// Human-readable name of an error code returned by the launch function.
extern "C" const char* lk_mvm_stage_left_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
