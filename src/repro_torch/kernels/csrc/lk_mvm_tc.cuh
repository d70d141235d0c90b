// Tensor-core body of the fused masked latent-Kronecker MVM for NVIDIA
// Hopper (sm_90a), shared by kernel K1 (lk_mvm_fused.cu, in the place of the
// reference's TPU kernel `lk_mvm_fused`) and kernel K3 (lk_mvm_fused_rows.cu,
// in the place of `lk_mvm_fused_rows`; both in src/repro/kernels/lk_mvm.py):
//
//   out[b] = mask_e * (A @ T[b]) + noise * (mask_e * u_e[b])
//   T[b]   = um[b] @ K2            (stage R below, never stored)
//
// A (n_rows, n) with row stride lda: K1 (n_rows = n) or one shard's K1_rows.
// um[b] (n, m): mask * U[b] formed in the prologue (K1, MASKED = true) or the
// caller's pre-masked um_full read as it is (K3). mask_e (n_rows, m) and
// u_e[b] (n_rows, m): the epilogue's mask and U at the output rows. K2 (m, m)
// with row stride ldk2. noise is read through a device pointer. float32 in,
// float32 out. (Kernel K2b, the two-stage route's stage L, is a wgmma kernel
// of its own over operands split before it runs: lk_mvm_stage_left.cu.)
//
// Instruction: mma.sync (m16n8k8 TF32, m16n8k16 BF16, float32 accumulators).
// wgmma would reach a higher share of the tensor cores' peak, but it needs
// both TF32 operands K-major in swizzled shared memory as exact TF32 values;
// mma.sync takes its fragments from registers, which is what lets this body
// split every float32 operand into two TF32 halves on the way in (below), T
// included, which it forms itself and never stores.
//
// Arithmetic.
// * f32 mode: 3xTF32. Each operand x is split as hi = cvt.rna.tf32(x),
//   lo = cvt.rna.tf32(x - hi); a product is lo*hi + hi*lo + hi*hi, summed in
//   float32. That keeps about 21 bits of each operand, against 11 for one TF32
//   pass, whose error would not hold the kernel to 1e-4 of the float64 answer
//   at n = 2000 (tests/test_torch_kernels.py emulates both).
// * bf16 mode: the operands are rounded to bfloat16 where the fragments are
//   built (the plain version's rounding points: K1, K2, U and T), products
//   summed in float32 on the BF16 tensor cores; the epilogue is float32.
// Within one k8 (k16) step the reduction index may be permuted freely as long
// as both operands use the same permutation: each thread's two (four) k values
// are taken as physically adjacent, so every fragment is one 8-byte (16-byte)
// shared-memory load.
//
// Decomposition.
// * The batch is folded into the GEMM's N dimension: a block owns BM = 256
//   output rows and a panel of BN = 128 flattened (b, j) columns, BPP batch
//   members of a JT-wide column tile (JT = 64 and BPP = 2 at m = 52 or 64).
//   Each tile of A it loads serves all 128 columns.
// * T = um @ K2 never reaches device memory. Per k tile of TK = 32 rows the
//   block forms T on the tensor cores (um as the A operand, K2^T resident in
//   shared memory and split into TF32 halves once) and stores it transposed,
//   T^T[(b, j)][k], K-major for stage L, its TF32 halves already split (or
//   bf16-rounded). T is recomputed once per 256-row block: m / 256 extra work
//   (0.25 at m = 64).
// * f32 mode sums each k step's three MMAs into a zeroed fragment and adds
//   it to the running sum with a float32 FADD: the tensor cores' accumulator
//   truncates, and n / 8 * 3 MMAs into one accumulator bias the sum enough
//   at n = 8192 to miss chip_smoke.py's 1e-4 check against float64.
// * Split-k in a thread-block cluster when the output tiles are too few for
//   the card: gridDim.z = splits blocks of one cluster each sum a contiguous
//   range of whole k tiles; rank 0 adds its peers' accumulators through
//   distributed shared memory in rank order and writes the output. One
//   launch, no workspace, no atomics: the same inputs give the same bits.
// * The whole grid (column tile, panels, row tiles, k tiles, splits) comes
//   from the wrapper's planner (kernels/lk_mvm.py: plan_launch) as a Plan;
//   the launcher checks it and launches it as it is.
// * Loads: a two-stage ring in shared memory fed by cp.async (16-byte copies
//   when every global row is 16-byte aligned, else 4-byte copies, each
//   zero-filled past the ragged edge by its source size); the next k tile
//   streams in while the block computes on this one. Blocks run in panel-
//   fastest order, so the blocks in flight share A's row strips and U's
//   panels in L2.
// * 512 threads (16 warps), at most 128 registers each. Stage L: warps
//   8 (rows) x 2 (columns), warp tile 32 x 64. Stage R: items of 16 k rows x
//   16 columns, one per warp. 208-214 KB of dynamic shared memory: one block
//   per SM.
//
// What bounds it now (H100, f32 mode, (65, 8192, 64); chip_smoke.py has the
// times): operations, at a fraction of the tensor cores' rate. Switching
// stages off one at a time in a development build put the most time in
// stage L (3 MMAs and a FADD per product, every A fragment split on the way
// into registers), then stage R, then the loads and barriers alone (each
// block and k tile moves 56 KB from L2); every instantiation spills (76-220
// bytes of stores a thread at 128 registers). The way past it is K2b's
// design (lk_mvm_stage_left.cu: wgmma fed by TMA from operands split
// before the kernel), which stage R, fused here, does not let K1 take as it
// is: T would have to be split and stored K-major in shared memory first.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "kernel_attr.cuh"

namespace lk_tc {

namespace cg = cooperative_groups;

constexpr int BM = 256;         // output rows per block
constexpr int BN = 128;         // flattened (b, j) panel columns per block
constexpr int TK = 32;          // k rows (A's columns) per pipeline stage
constexpr int STAGES = 2;       // depth of the shared-memory ring
constexpr int KR_MAX = 64;      // largest chunk of m in stage R's reduction
constexpr int WARPS_M = 8, WARPS_N = 2;   // stage L: warp grid
constexpr int MT = BM / WARPS_M / 16;     // 16-row fragments per warp
constexpr int NTHREADS = 32 * WARPS_M * WARPS_N;
constexpr int MAX_SPLITS = 8;   // portable cluster size

template <bool BF16> struct Layout {
    // Row strides (floats) of the shared tiles: 8 mod 32 for TF32's 8-byte
    // fragment loads, 16 mod 32 for BF16's 16-byte ones (no bank conflicts).
    static constexpr int LDA = BF16 ? TK + 16 : TK + 8;
    static constexpr int LDT = BF16 ? TK + 16 : TK + 8;
    // Stage R's row stride LDU (runtime, from m) is at most LDU_MAX; the U
    // tiles of one stage (BPP batch members x TK rows) take at most U_FLOATS.
    static constexpr int LDU_MAX = BF16 ? 80 : 72;
    static constexpr int U_FLOATS = BF16 ? 6144 : 5120;
    static constexpr int MK_FLOATS = TK * LDU_MAX;                // mask tile
    static constexpr int K2T_FLOATS = (BF16 ? 1 : 2) * 64 * LDU_MAX;  // K2^T (hi, lo)
    static constexpr int A_FLOATS = BM * LDA;
    static constexpr int STAGE_FLOATS = A_FLOATS + U_FLOATS + MK_FLOATS;
    static constexpr int T_FLOATS = (BF16 ? 1 : 2) * BN * LDT;
    static constexpr int FLOATS = STAGES * STAGE_FLOATS + K2T_FLOATS + T_FLOATS;
    static constexpr int BYTES = FLOATS * (int)sizeof(float);
    static_assert(STAGES * STAGE_FLOATS >= BM * BN, "split-k buffer must fit the ring");
    static_assert(BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0 && TK % 16 == 0,
                  "warp tiles must tile the block");
    static_assert(BYTES <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One cp.async of VEC floats; a source size of 0 writes zeros (ragged edge).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = valid ? VEC * 4 : 0;
    if constexpr (VEC == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(bytes));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(src), "r"(bytes));
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The launch plan, decided on the host by the wrapper's planner
// (kernels/lk_mvm.py: plan_launch, the one place that chooses it) and
// launched as it is: grid (panels, row_tiles, splits), a panel being
// batch_per_panel members of a col_tile-wide column tile, the reduction
// k_tiles tiles of TK rows. launch() only checks that the grid covers the
// output once and fits the shared-memory layout.
struct Plan {
    int row_tiles, panels, k_tiles, col_tile, batch_per_panel, splits;
};

struct Args {
    const float* A; long long lda;   // (n_rows, n)
    const float* K2; long long ldk2; // (m, m)
    const float* um;                 // (B, n, m): U (MASKED) or um_full
    const float* mask_p;             // (n, m) prologue mask (MASKED only)
    const float* mask_e;             // (n_rows, m) epilogue mask
    const float* u_e;                // (B, n_rows, m) epilogue U
    const float* noise;              // device scalar
    float* out;                      // (B, n_rows, m)
    int B, n_rows, n, m;
    Plan plan;
};

template <bool BF16, int VEC, bool MASKED>
__global__ void __launch_bounds__(NTHREADS, 1) lk_mvm_tc_kernel(const Args p) {
    constexpr int NT = BN / WARPS_N / 8;   // 8-column fragments per warp
    using L = Layout<BF16>;
    extern __shared__ __align__(16) float smem[];
    float* const k2t = smem + STAGES * L::STAGE_FLOATS;  // [64 j][LDU]  K2^T chunk (hi / bf16)
    float* const k2l = k2t + 64 * L::LDU_MAX;            // [64 j][LDU]  K2^T chunk (lo), f32 mode
    float* const Th = k2t + L::K2T_FLOATS;               // [BN][LDT]    T^T (hi / bf16)
    float* const Tl = Th + BN * L::LDT;                  // [BN][LDT]    T^T (lo), f32 mode

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int n = p.n, m = p.m;
    const int JT = p.plan.col_tile, BPP = p.plan.batch_per_panel;
    const int KR = m <= KR_MAX ? JT : KR_MAX;        // stage R chunk of m
    const int nchunks = (m + KR - 1) / KR;
    const int LDU = (KR + 31) / 32 * 32 + (BF16 ? 16 : 8);
    const int jtiles = (m + JT - 1) / JT;
    const int b0 = (int)(blockIdx.x / jtiles) * BPP;
    const int j0 = (int)(blockIdx.x % jtiles) * JT;
    const int i0 = blockIdx.y * BM;
    const int KT = p.plan.k_tiles, splits = p.plan.splits;
    const int kt_begin = (int)((long long)blockIdx.z * KT / splits);
    const int kt_end = (int)((long long)(blockIdx.z + 1) * KT / splits);
    const size_t plane = (size_t)n * (size_t)m;

    auto A_s = [&](int s) { return smem + s * L::STAGE_FLOATS; };
    auto U_s = [&](int s) { return smem + s * L::STAGE_FLOATS + L::A_FLOATS; };
    auto M_s = [&](int s) { return U_s(s) + L::U_FLOATS; };

    // ---- loads into the ring (cp.async, zero-filled past every edge)
    auto load_A = [&](int s, int kt) {
        float* dst = A_s(s);
        const int k0 = kt * TK;
        constexpr int CPR = TK / VEC;
        for (int q = tid; q < BM * CPR; q += NTHREADS) {
            const int r = q / CPR, c = (q % CPR) * VEC;
            const int gi = i0 + r, gk = k0 + c;
            const bool ok = gi < p.n_rows && gk < n;
            cp_async<VEC>(dst + r * L::LDA + c,
                          ok ? p.A + (size_t)gi * p.lda + gk : p.A, ok);
        }
    };
    auto load_U = [&](int s, int kt, int c0) {   // mm in [c0, c0 + KR)
        const int k0 = kt * TK;
        const int cpr = KR / VEC;
        float* dst = U_s(s);
        for (int q = tid; q < BPP * TK * cpr; q += NTHREADS) {
            const int c = (q % cpr) * VEC, rest = q / cpr;
            const int r = rest % TK, bl = rest / TK;
            const int b = b0 + bl, gk = k0 + r, mm = c0 + c;
            const bool ok = b < p.B && gk < n && mm < m;
            cp_async<VEC>(dst + (bl * TK + r) * LDU + c,
                          ok ? p.um + (size_t)b * plane + (size_t)gk * m + mm
                             : p.um, ok);
        }
        if constexpr (MASKED) {
            float* md = M_s(s);
            for (int q = tid; q < TK * cpr; q += NTHREADS) {
                const int c = (q % cpr) * VEC, r = q / cpr;
                const int gk = k0 + r, mm = c0 + c;
                const bool ok = gk < n && mm < m;
                cp_async<VEC>(md + r * LDU + c,
                              ok ? p.mask_p + (size_t)gk * m + mm : p.mask_p, ok);
            }
        }
    };
    auto load_tile = [&](int kt) {   // one commit group per k tile, maybe empty
        if (kt < kt_end) {
            const int s = (kt - kt_begin) % STAGES;
            load_A(s, kt);
            load_U(s, kt, 0);
        }
        cp_async_commit();
    };
    // K2^T[j][mm] = K2[c0 + mm][j0 + j], plain loads (small, once per sweep
    // when m <= 64), split into TF32 halves here once in f32 mode.
    auto load_k2t = [&](int c0) {
        for (int q = tid; q < 64 * KR; q += NTHREADS) {
            const int jl = q % 64, mm = q / 64;
            const int gj = j0 + jl, gm = c0 + mm;
            float v = 0.f;
            if (jl < JT && gj < m && gm < m) v = p.K2[(size_t)gm * p.ldk2 + gj];
            if constexpr (BF16) {
                k2t[jl * LDU + mm] = v;
            } else {
                uint32_t h, l;
                split(v, h, l);
                k2t[jl * LDU + mm] = __uint_as_float(h);
                k2l[jl * LDU + mm] = __uint_as_float(l);
            }
        }
    };

    // ---- stage R: T[k, (b, j)] = sum_mm um[b, k, mm] * K2[mm, j] for the TK
    //      rows of k tile kt, stored transposed (T^T[(b, j)][k], K-major for
    //      stage L), in items of 16 k rows x 16 columns of one batch member
    //      (warp w takes items w, w + NWARPS, ...).
    const int jq_n = JT / 16, items = BPP * (TK / 16) * jq_n;
    auto stage_R_item = [&](int s, int item, bool first, bool last) {
        const int jq = item % jq_n, kq = (item / jq_n) % (TK / 16);
        const int bl = item / jq_n / (TK / 16);
        const float* Ur = U_s(s) + (bl * TK + kq * 16 + gid) * LDU;
        const float* Mr = M_s(s) + (kq * 16 + gid) * LDU;
        const float* Bh = k2t + (jq * 16 + gid) * LDU;
        const float* Bl = k2l + (jq * 16 + gid) * LDU;
        float t[2][4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[f][e] = 0.f;
        if (b0 + bl < p.B) {
            if constexpr (BF16) {
                for (int mm = 0; mm < KR; mm += 16) {
                    float4 x0 = *reinterpret_cast<const float4*>(Ur + mm + 4 * tig);
                    float4 x1 = *reinterpret_cast<const float4*>(Ur + 8 * LDU + mm + 4 * tig);
                    if constexpr (MASKED) {
                        const float4 m0 = *reinterpret_cast<const float4*>(Mr + mm + 4 * tig);
                        const float4 m1 = *reinterpret_cast<const float4*>(Mr + 8 * LDU + mm + 4 * tig);
                        x0.x *= m0.x; x0.y *= m0.y; x0.z *= m0.z; x0.w *= m0.w;
                        x1.x *= m1.x; x1.y *= m1.y; x1.z *= m1.z; x1.w *= m1.w;
                    }
                    const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                           pack_bf16(x0.z, x0.w), pack_bf16(x1.z, x1.w)};
#pragma unroll
                    for (int f = 0; f < 2; ++f) {
                        const float4 w = *reinterpret_cast<const float4*>(
                            Bh + f * 8 * LDU + mm + 4 * tig);
                        mma_bf16(t[f], a, pack_bf16(w.x, w.y), pack_bf16(w.z, w.w));
                    }
                }
            } else {
                for (int mm = 0; mm < KR; mm += 8) {
                    float2 x0 = *reinterpret_cast<const float2*>(Ur + mm + 2 * tig);
                    float2 x1 = *reinterpret_cast<const float2*>(Ur + 8 * LDU + mm + 2 * tig);
                    if constexpr (MASKED) {
                        const float2 m0 = *reinterpret_cast<const float2*>(Mr + mm + 2 * tig);
                        const float2 m1 = *reinterpret_cast<const float2*>(Mr + 8 * LDU + mm + 2 * tig);
                        x0.x *= m0.x; x0.y *= m0.y;
                        x1.x *= m1.x; x1.y *= m1.y;
                    }
                    uint32_t ah[4], al[4];
                    split(x0.x, ah[0], al[0]);
                    split(x1.x, ah[1], al[1]);
                    split(x0.y, ah[2], al[2]);
                    split(x1.y, ah[3], al[3]);
#pragma unroll
                    for (int f = 0; f < 2; ++f) {
                        const float2 wh = *reinterpret_cast<const float2*>(
                            Bh + f * 8 * LDU + mm + 2 * tig);
                        const float2 wl = *reinterpret_cast<const float2*>(
                            Bl + f * 8 * LDU + mm + 2 * tig);
                        const uint32_t h0 = __float_as_uint(wh.x), h1 = __float_as_uint(wh.y);
                        // a zeroed fragment per k step, as in stage L: no
                        // long chain of dependent MMAs, no truncation drift
                        float d[4] = {0.f, 0.f, 0.f, 0.f};
                        mma_tf32(d, al, h0, h1);
                        mma_tf32(d, ah, __float_as_uint(wl.x), __float_as_uint(wl.y));
                        mma_tf32(d, ah, h0, h1);
#pragma unroll
                        for (int e = 0; e < 4; ++e) t[f][e] += d[e];
                    }
                }
            }
        }
        // Th / Tl were last read by stage L of the previous k tile, before
        // the barrier at the top of this one. With m in several chunks, Th
        // holds the float32 partial sum until the last chunk.
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int k = kq * 16 + gid + 8 * (e >> 1);
                const int col = bl * JT + jq * 16 + f * 8 + 2 * tig + (e & 1);
                float v = t[f][e];
                if (!first) v += Th[col * L::LDT + k];
                if (!last) {
                    Th[col * L::LDT + k] = v;
                } else if constexpr (BF16) {
                    Th[col * L::LDT + k] = round_bf16(v);
                } else {
                    uint32_t h, l;
                    split(v, h, l);
                    Th[col * L::LDT + k] = __uint_as_float(h);
                    Tl[col * L::LDT + k] = __uint_as_float(l);
                }
            }
        }
    };
    auto stage_R = [&](int s, int kt) {
        for (int ch = 0; ch < nchunks; ++ch) {
            if (nchunks > 1) {   // m > 64: chunks of K2^T and U in turn
                __syncthreads();
                if (ch > 0) {
                    load_U(s, kt, ch * KR);
                    cp_async_commit();
                }
                load_k2t(ch * KR);
                cp_async_wait<0>();
                __syncthreads();
            }
            for (int item = warp; item < items; item += NTHREADS / 32)
                stage_R_item(s, item, ch == 0, ch == nchunks - 1);
        }
    };

    // ---- stage L: acc += A[i-rows, k tile] @ T[k tile, panel]; warp tile
    //      MT x NT fragments of 16 x 8.
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    auto stage_L = [&](int s) {
        const float* Ab = A_s(s) + (wm * MT * 16 + gid) * L::LDA;
        const float* Tb = Th + (wn * NT * 8 + gid) * L::LDT;
        if constexpr (BF16) {
#pragma unroll
            for (int ks = 0; ks < TK; ks += 16) {
                uint32_t a[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const float4 x0 = *reinterpret_cast<const float4*>(
                        Ab + mt * 16 * L::LDA + ks + 4 * tig);
                    const float4 x1 = *reinterpret_cast<const float4*>(
                        Ab + (mt * 16 + 8) * L::LDA + ks + 4 * tig);
                    a[mt][0] = pack_bf16(x0.x, x0.y);
                    a[mt][1] = pack_bf16(x1.x, x1.y);
                    a[mt][2] = pack_bf16(x0.z, x0.w);
                    a[mt][3] = pack_bf16(x1.z, x1.w);
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float4 h = *reinterpret_cast<const float4*>(
                        Tb + nt * 8 * L::LDT + ks + 4 * tig);
                    const uint32_t b0 = pack_bf16(h.x, h.y), b1 = pack_bf16(h.z, h.w);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
                }
            }
        } else {
            // The tensor cores' accumulator truncates: n / 8 * 3 MMAs into
            // one sum would bias it. So each k step's three MMAs go into a
            // zeroed fragment d, added to acc with a rounding float32 FADD.
            const float* Tlb = Tl + (wn * NT * 8 + gid) * L::LDT;
#pragma unroll
            for (int ks = 0; ks < TK; ks += 8) {
                uint32_t ah[MT][4], al[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const float2 x0 = *reinterpret_cast<const float2*>(
                        Ab + mt * 16 * L::LDA + ks + 2 * tig);
                    const float2 x1 = *reinterpret_cast<const float2*>(
                        Ab + (mt * 16 + 8) * L::LDA + ks + 2 * tig);
                    split(x0.x, ah[mt][0], al[mt][0]);
                    split(x1.x, ah[mt][1], al[mt][1]);
                    split(x0.y, ah[mt][2], al[mt][2]);
                    split(x1.y, ah[mt][3], al[mt][3]);
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const float2 h = *reinterpret_cast<const float2*>(
                        Tb + nt * 8 * L::LDT + ks + 2 * tig);
                    const float2 l = *reinterpret_cast<const float2*>(
                        Tlb + nt * 8 * L::LDT + ks + 2 * tig);
                    const uint32_t h0 = __float_as_uint(h.x), h1 = __float_as_uint(h.y);
                    const uint32_t l0 = __float_as_uint(l.x), l1 = __float_as_uint(l.y);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        float d[4] = {0.f, 0.f, 0.f, 0.f};
                        mma_tf32(d, al[mt], h0, h1);
                        mma_tf32(d, ah[mt], l0, l1);
                        mma_tf32(d, ah[mt], h0, h1);
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += d[e];
                    }
                }
            }
        }
    };

    // ---- the k sweep of this split: a ring of STAGES tiles, the next
    //      STAGES - 1 in flight
    for (int q = tid; q < L::T_FLOATS; q += NTHREADS) Th[q] = 0.f;  // unused columns
    if (nchunks == 1) load_k2t(0);   // resident for the whole sweep
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) load_tile(kt_begin + t);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int s = (kt - kt_begin) % STAGES;
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // tile kt landed; everyone is done with tile kt - 1
        load_tile(kt + STAGES - 1);
        stage_R(s, kt);
        __syncthreads();   // T of tile kt complete
        stage_L(s);
    }

    // ---- split-k: rank 0 of the cluster adds its peers' sums in rank order
    if (splits > 1) {
        cp_async_wait<0>();
        __syncthreads();   // the ring is free: it becomes the exchange buffer
        float* red = smem;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    red[((mt * NT + nt) * 4 + e) * NTHREADS + tid] = acc[mt][nt][e];
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        const unsigned rank = cluster.block_rank();
        if (rank == 0) {
            for (int r = 1; r < splits; ++r) {
                const float* peer = cluster.map_shared_rank(red, r);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[mt][nt][e] += peer[((mt * NT + nt) * 4 + e) * NTHREADS + tid];
            }
        }
        cluster.sync();    // peers keep their shared memory until rank 0 is done
        if (rank != 0) return;
    }

    // ---- epilogue: out = mask_e * acc + noise * (mask_e * u_e)
    const float noise = *p.noise;
    const size_t out_plane = (size_t)p.n_rows * (size_t)m;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = i0 + wm * MT * 16 + mt * 16 + gid + 8 * h;
            if (i >= p.n_rows) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = wn * NT * 8 + nt * 8 + 2 * tig + e;
                    const int bl = c / JT, jl = c - bl * JT;
                    const int b = b0 + bl, j = j0 + jl;
                    if (bl >= BPP || b >= p.B || j >= m) continue;
                    const size_t o = (size_t)i * m + j;
                    const size_t ob = (size_t)b * out_plane + o;
                    const float mk = p.mask_e[o];
                    float u = p.u_e[ob];
                    if constexpr (BF16) u = round_bf16(u);
                    p.out[ob] = mk * acc[mt][nt][2 * h + e] + noise * (mk * u);
                }
            }
        }
    }
}

// Launches the body on `stream` with the grid of p.plan: plan.splits blocks
// along k in one cluster (1 = no split). Picks 16-byte or 4-byte copies from
// the operands' alignment. Returns the CUDA error code (0 = success;
// cudaErrorInvalidValue for a plan that does not cover the output or does
// not fit the layout); does not synchronise and allocates nothing.
template <bool MASKED>
inline int launch(const Args& p, int bf16, void* stream) {
    if (p.B <= 0 || p.n_rows <= 0 || p.n <= 0 || p.m <= 0 || p.n_rows > p.n)
        return (int)cudaErrorInvalidValue;
    const Plan& q = p.plan;
    const int JT = q.col_tile, BPP = q.batch_per_panel;
    if (JT < 16 || JT > KR_MAX || JT % 16 != 0 || BPP < 1 || BPP * JT > BN)
        return (int)cudaErrorInvalidValue;
    const int KR = p.m <= KR_MAX ? JT : KR_MAX;   // as in the kernel
    const int LDU = (KR + 31) / 32 * 32 + (bf16 ? 16 : 8);
    if (BPP * TK * LDU > (bf16 ? Layout<true>::U_FLOATS : Layout<false>::U_FLOATS))
        return (int)cudaErrorInvalidValue;
    // the grid covers every output element once and k in whole tiles
    if ((long long)q.row_tiles != ((long long)p.n_rows + BM - 1) / BM
        || (long long)q.panels != ((long long)p.B + BPP - 1) / BPP * ((p.m + JT - 1) / JT)
        || (long long)q.k_tiles != ((long long)p.n + TK - 1) / TK
        || q.splits < 1 || q.splits > MAX_SPLITS || q.splits > q.k_tiles)
        return (int)cudaErrorInvalidValue;
    if (q.row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
    const uintptr_t ptrs = (uintptr_t)p.A | (uintptr_t)p.um
                           | (MASKED ? (uintptr_t)p.mask_p : (uintptr_t)0);
    const bool vec4 = (ptrs % 16 == 0) && (p.lda % 4 == 0) && (p.n % 4 == 0)
                      && (p.m % 4 == 0);
    void (*kernel)(const Args);
    int bytes;
    if (bf16) {
        kernel = vec4 ? lk_mvm_tc_kernel<true, 4, MASKED> : lk_mvm_tc_kernel<true, 1, MASKED>;
        bytes = Layout<true>::BYTES;
    } else {
        kernel = vec4 ? lk_mvm_tc_kernel<false, 4, MASKED>
                      : lk_mvm_tc_kernel<false, 1, MASKED>;
        bytes = Layout<false>::BYTES;
    }
    // More than 48 KB of dynamic shared memory has to be asked for, once per
    // instantiation and device. (Two threads racing here set the same value.)
    constexpr int MAX_DEVICES = 64;
    static bool smem_set[4][MAX_DEVICES] = {};
    const int which = 2 * (bf16 != 0) + (vec4 ? 1 : 0);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !smem_set[which][dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) smem_set[which][dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)q.panels, (unsigned)q.row_tiles, (unsigned)q.splits);
    cfg.blockDim = dim3(NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = (unsigned)q.splits;
    cfg.attrs = attr;
    cfg.numAttrs = q.splits > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The runtime's view of the body's instantiations that launch<MASKED>()
// picks, at their launch: which = 0 f32 with 16-byte
// copies, 1 f32 with 4-byte copies, 2 bf16 16-byte, 3 bf16 4-byte (the
// order of kernels/budget.py's entries).
template <bool MASKED>
inline int attributes(int which, KernelAttr* out) {
    switch (which) {
    case 0: return kernel_attributes(lk_mvm_tc_kernel<false, 4, MASKED>, NTHREADS,
                                     Layout<false>::BYTES, out);
    case 1: return kernel_attributes(lk_mvm_tc_kernel<false, 1, MASKED>, NTHREADS,
                                     Layout<false>::BYTES, out);
    case 2: return kernel_attributes(lk_mvm_tc_kernel<true, 4, MASKED>, NTHREADS,
                                     Layout<true>::BYTES, out);
    case 3: return kernel_attributes(lk_mvm_tc_kernel<true, 1, MASKED>, NTHREADS,
                                     Layout<true>::BYTES, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace lk_tc
