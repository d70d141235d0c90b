// Stage R of the two-stage masked latent-Kronecker matrix-vector product
// (kernel K2a) for NVIDIA Hopper (sm_90a):
//
//   T[b] = (mask * U[b]) @ K2          (float32, 3xTF32 on the tensor cores)
//
// written for stage L (kernel K2b, lk_mvm_stage_left.cu) transposed and split:
// T_hi = cvt.rna.tf32(T), T_lo = cvt.rna.tf32(T - T_hi), each a plane of
// B m rows (one per flattened column (b, j)) by n, row stride ldt. K2 (m, m)
// with unit stride along its rows and row stride ldk2, mask (n, m) of 0/1
// floats, U (B, n, m) contiguous.
//
// Replaces the TPU kernel `_stage_right_kernel` of `lk_mvm_two_stage` in the
// reference (src/repro/kernels/lk_mvm.py). The reference pads every operand
// to block multiples on the host and accumulates over its innermost grid axis
// in a scratch tile; here a block loops over the reduction itself and every
// load is zero-filled past the ragged edge.
//
// What bounds it: bytes. It does 2 m flops per 12 bytes moved (U and mask
// in, the two halves of T out), 10 flops per byte at m = 64, at every shape
// below the card's ridge, so the design is about its loads and stores. Its
// work is cut into strips of SR = 64 rows of one batch member (row tile it of
// member b); persistent blocks, two per SM, each take a contiguous range of
// strips in (it, b) order from the wrapper's planner (kernels/lk_mvm.py:
// plan_stream). So K2^T, split into TF32 halves, is loaded once per block,
// and so is the mask tile of a row tile, which a block's strips share (one or
// two row tiles per block at the main shapes): only U streams in, through a
// three-deep cp.async ring (16-byte copies where rows are 16-byte aligned,
// zero-filled 4-byte copies otherwise), two strips ahead of the tensor
// cores. Each warp owns 16 rows of the strip and all its columns; it writes
// its product transposed over its own rows of the ring slot it has just read
// and stores each column's 16 rows as 64-byte runs of both planes, so the
// only block-wide barrier per strip is the ring's. (This narrow kernel holds
// m <= 64; beyond, the wide kernel below.) Each k step's three MMAs go into
// a zeroed fragment that a rounding FADD adds to the output fragment, as in
// K1's stage R: accumulating the 24 MMAs of m = 64 in place let the tensor
// cores' truncation bias T toward zero by ~5e-7 of itself, ten times the
// bias of this order (emulated in tests/test_torch_kernels.py), and CG solutions
// amplify it (at n = 8192 the routed serve needed 12-21 % more iterations;
// PERF.md). K2^T keeps each value's two TF32 halves side by side, one 16-byte
// shared load per B fragment. The split of T into halves is the one K2b's
// operands need (wgmma reads TF32 values from shared memory): done here, as T
// is stored, it costs a second plane of stores and no pass of its own.

#include "lk_mvm_tc.cuh"

namespace lk_two_stage {

// The grid of stage R, decided on the host by the wrapper's planner
// (kernels/lk_mvm.py: plan_stream) and launched as it is: `strips` strips of
// `strip_rows` rows, strip q being row tile q / B of batch member q % B;
// block j of `blocks` takes strips [j strips / blocks, (j + 1) strips /
// blocks).
struct StreamPlan {
    int strip_rows, strips, blocks;
};

using lk_tc::KR_MAX;

constexpr int SR = 64;                 // rows per strip: 16 per warp
constexpr int NTHREADS = 128;          // 4 warps
constexpr int STAGES = 3;              // depth of the U ring
constexpr int LDU_MAX = KR_MAX + 8;    // row stride of the U and mask tiles (floats)
constexpr int SLOT = SR * LDU_MAX;     // one U (or mask) tile
// K2^T as [j][mm][hi, lo]: row stride 16 mod 32 floats, so the 16-byte B
// fragment loads of a quarter warp hit 32 distinct banks.
constexpr int LDK = 2 * KR_MAX + 16;
constexpr int K2T = KR_MAX * LDK;
constexpr int BYTES = (STAGES * SLOT + SLOT + K2T) * (int)sizeof(float);
constexpr int JQ_MAX = KR_MAX / 16;    // 16-column items per warp
// T^T of a warp's 16 rows, [j][r] with this row stride, in the warp's own
// 16 rows of a ring slot (64 x 18 <= 16 x LDU_MAX floats).
constexpr int LDTS = 18;
static_assert(KR_MAX * LDTS <= 16 * LDU_MAX, "T^T of a warp fits its rows of a slot");
static_assert(SR == 16 * (NTHREADS / 32), "a warp owns 16 rows of a strip");
static_assert(2 * (BYTES + 1024) <= 233472, "two blocks must fit on an SM");

// The narrow kernel, m <= 64. FULL: 48 < m <= 64 (the main shapes), the
// 64-wide column tile and every loop bound compile-time constants; else the
// tile is m rounded up to 16.
template <int VEC, bool FULL>
__global__ void __launch_bounds__(NTHREADS, 2)
stage_right_kernel(const float* __restrict__ U, const float* __restrict__ mask,
                   const float* __restrict__ K2, long long ldk2,
                   float* __restrict__ T_hi, float* __restrict__ T_lo, long long ldt,
                   int B, int n, int m, int strips) {
    using lk_tc::cp_async;
    extern __shared__ __align__(16) float smem[];
    float* const M_s = smem + STAGES * SLOT;   // [r][mm] mask tile
    float* const k2t = M_s + SLOT;             // [j][mm][hi, lo] K2^T

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    // The output column tile is also the whole reduction.
    const int JT = FULL ? KR_MAX : (m + 15) / 16 * 16;
    const int LDU = (JT + 31) / 32 * 32 + 8;
    const int jq_n = JT / 16;
    const int q_begin = (int)((long long)blockIdx.x * strips / gridDim.x);
    const int q_end = (int)((long long)(blockIdx.x + 1) * strips / gridDim.x);
    const size_t plane = (size_t)n * (size_t)m;

    auto U_s = [&](int s) { return smem + s * SLOT; };

    // ---- U rows of the next strip to load, lq, into ring slot `slot` (one
    //      commit group, maybe empty).
    int lq = q_begin;
    auto load_next = [&](int slot) {
        if (lq < q_end) {
            const int tile = lq / B;
            const int i0 = tile * SR, b = lq - tile * B;
            const float* src = U + (size_t)b * plane;
            float* dst = U_s(slot);
            const int cpr = JT / VEC;
            for (int e = tid; e < SR * cpr; e += NTHREADS) {
                const int r = e / cpr, c = (e - r * cpr) * VEC;
                const int i = i0 + r;
                const bool ok = i < n && c < m;
                cp_async<VEC>(dst + r * LDU + c,
                              ok ? src + (size_t)i * m + c : U, ok);
            }
            ++lq;
        }
        lk_tc::cp_async_commit();
    };
    // The mask tile of row tile i0 / SR, and K2^T[j][mm] = K2[mm][j] split
    // into TF32 halves: plain loads, neighbouring threads on neighbouring
    // columns, each thread's EACH loads all issued before the first is used
    // (one round trip to L2, not EACH in a row).
    constexpr int EACH = SR * KR_MAX / NTHREADS;
    static_assert(EACH * NTHREADS == KR_MAX * KR_MAX, "K2^T and mask tiles alike");
    auto load_mask = [&](int i0) {
        float v[EACH];
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, r = e / JT, c = e - r * JT;
            const int i = i0 + r;
            v[k] = e < SR * JT && i < n && c < m ? mask[(size_t)i * m + c] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, r = e / JT, c = e - r * JT;
            if (e < SR * JT) M_s[r * LDU + c] = v[k];
        }
    };
    auto load_k2t = [&]() {
        float v[EACH];
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, jl = e % JT, mm = e / JT;
            v[k] = e < JT * JT && jl < m && mm < m ? K2[(size_t)mm * ldk2 + jl] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, jl = e % JT, mm = e / JT;
            if (e >= JT * JT) continue;
            uint32_t h, l;
            lk_tc::split(v[k], h, l);
            *reinterpret_cast<float2*>(k2t + jl * LDK + 2 * mm) =
                make_float2(__uint_as_float(h), __uint_as_float(l));
        }
    };

    float acc[JQ_MAX][2][4];
    int mask_i0 = -1;   // row of the resident mask tile
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) load_next(t);
    if (q_begin < q_end) {   // under the first strips' copies
        load_k2t();          // for the whole launch
        mask_i0 = q_begin / B * SR;
        load_mask(mask_i0);
    }
    for (int q = q_begin; q < q_end; ++q) {
        const int st = q - q_begin, s = st % STAGES;
        const int tile = q / B, i0 = tile * SR, b = q - tile * B;
        lk_tc::cp_async_wait<STAGES - 2>();
        __syncthreads();   // strip q landed; strip q - 1 is done with the ring
        load_next((st + STAGES - 1) % STAGES);
        if (i0 != mask_i0) {
            load_mask(i0);
            mask_i0 = i0;
            __syncthreads();
        }
#pragma unroll
        for (int jq = 0; jq < JQ_MAX; ++jq)
#pragma unroll
            for (int f = 0; f < 2; ++f)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[jq][f][e] = 0.f;
        // The warp's 16 rows times every 16-column item: the operand split of
        // lk_mvm_tc.cuh's stage R, the mask applied on the way into the
        // fragments, each k step's three MMAs summed apart and added.
        float* const Ur = U_s(s) + (warp * 16 + gid) * LDU;
        const float* Mr = M_s + (warp * 16 + gid) * LDU;
#pragma unroll
        for (int mm = 0; mm < KR_MAX; mm += 8) {
            if (mm >= JT) break;
            float2 x0 = *reinterpret_cast<const float2*>(Ur + mm + 2 * tig);
            float2 x1 = *reinterpret_cast<const float2*>(Ur + 8 * LDU + mm + 2 * tig);
            const float2 m0 = *reinterpret_cast<const float2*>(Mr + mm + 2 * tig);
            const float2 m1 = *reinterpret_cast<const float2*>(Mr + 8 * LDU + mm + 2 * tig);
            x0.x *= m0.x; x0.y *= m0.y;
            x1.x *= m1.x; x1.y *= m1.y;
            uint32_t ah[4], al[4];
            lk_tc::split(x0.x, ah[0], al[0]);
            lk_tc::split(x1.x, ah[1], al[1]);
            lk_tc::split(x0.y, ah[2], al[2]);
            lk_tc::split(x1.y, ah[3], al[3]);
#pragma unroll
            for (int jq = 0; jq < JQ_MAX; ++jq) {
                if (jq >= jq_n) break;
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                    // (hi, lo) of K2^T[j][mm + 2 tig] and [mm + 2 tig + 1]
                    const float4 w = *reinterpret_cast<const float4*>(
                        k2t + (jq * 16 + f * 8 + gid) * LDK + 2 * (mm + 2 * tig));
                    const uint32_t h0 = __float_as_uint(w.x), h1 = __float_as_uint(w.z);
                    // a zeroed fragment per k step, added with a rounding
                    // FADD: the tensor cores' accumulation truncates, and
                    // truncating into the running sum biases T toward zero
                    float d[4] = {0.f, 0.f, 0.f, 0.f};
                    lk_tc::mma_tf32(d, al, h0, h1);
                    lk_tc::mma_tf32(d, ah, __float_as_uint(w.y), __float_as_uint(w.w));
                    lk_tc::mma_tf32(d, ah, h0, h1);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[jq][f][e] += d[e];
                }
            }
        }

        // ---- the warp's 16 rows of T, transposed (T^T[j][r], row stride
        //      LDTS) over its own rows of the slot it has just read, then out
        //      split into TF32 halves: for each column (b, j) 16 consecutive
        //      rows of k, 64-byte runs of each plane
        __syncwarp();
        float* const Ts = U_s(s) + warp * 16 * LDU;
#pragma unroll
        for (int jq = 0; jq < JQ_MAX; ++jq) {
            if (jq >= jq_n) break;
#pragma unroll
            for (int f = 0; f < 2; ++f)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    Ts[(jq * 16 + f * 8 + 2 * tig + (e & 1)) * LDTS + gid + 8 * (e >> 1)] =
                        acc[jq][f][e];
        }
        __syncwarp();
        for (int e = lane; e < 16 * JT; e += 32) {
            const int jl = e >> 4, r = e & 15;
            const int i = i0 + warp * 16 + r;
            if (i >= n || jl >= m) continue;
            uint32_t h, l;
            lk_tc::split(Ts[jl * LDTS + r], h, l);
            const size_t o = ((size_t)b * m + jl) * (size_t)ldt + i;
            T_hi[o] = __uint_as_float(h);
            T_lo[o] = __uint_as_float(l);
        }
    }
}

// ---- m > 64: the wide kernel -------------------------------------------
//
// Each warp holds its 16 rows of the strip times every output column of a
// pass (up to NJ = 240, in registers), so one pass of U covers all of T's
// columns at m <= 240: U is read once, and the mask with it. The reduction
// streams through a double-buffered cp.async ring in chunks of KC: a chunk
// of U and of the mask (SR rows by KC) and KC rows of K2 (as stored: k rows,
// j contiguous; row stride LDB = 8 mod 32, so a warp's B fragment loads hit
// 32 banks). K2 is 160 KB at m = 200, too large to stay in shared memory
// beside the ring, so each strip reads it again from L2, as float32, and
// each warp splits the values it multiplies into TF32 halves (split_alu:
// cvt.rna's bits from integer operations, which issue faster: 0.780
// against 0.914 ms a launch at (65, 4096, 200) on an H100). The k steps,
// and each step's three MMAs into a zeroed fragment added with a rounding
// FADD, run in the order of the narrow kernel. The 8-column fragments go
// in groups of NG with no branch inside a group, so that the compiler
// interleaves their MMA chains (a test per fragment left one chain in
// flight); NG = 5 and NJ = 240 make m = 200 five whole groups. What bounds
// it is the rate of mma.sync's TF32 MMAs, three a product, not bytes. T
// leaves from the fragments: for each column (b, j), runs of 8 rows (32
// bytes) of each plane. m > NJ takes ceil(m / NJ) passes.
constexpr int KC = 32;                 // k rows of K2 a stage
constexpr int WSTAGES = 2;             // depth of the ring
constexpr int NJ = 240;                // output columns a pass
constexpr int NT = NJ / 8;             // 8-column fragments a warp holds
constexpr int NG = 5;                  // fragments of a group (see below)
constexpr int LDW = KC + 4;            // row stride of the U and mask chunks
constexpr int LDB = NJ + 24;           // row stride of the K2 chunk
constexpr int WSTAGE = 2 * SR * LDW + KC * LDB;
static_assert(WSTAGES * WSTAGE * (int)sizeof(float) <= BYTES,
              "the wide ring fits the narrow kernel's shared memory");
static_assert(LDW % 8 == 4 && LDB % 32 == 8, "conflict-free fragment loads");
static_assert(NT % NG == 0, "whole groups of fragments");

// cvt.rna.tf32.f32 on the bit pattern: to nearest, ties away from zero (a
// carry into the 13 cleared bits rounds the magnitude up).
__device__ __forceinline__ uint32_t tf32_alu(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_alu(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_alu(x);
    lo = tf32_alu(x - __uint_as_float(hi));
}

template <int VEC>
__global__ void __launch_bounds__(NTHREADS, 2)
stage_right_kernel_wide(const float* __restrict__ U, const float* __restrict__ mask,
                        const float* __restrict__ K2, long long ldk2,
                        float* __restrict__ T_hi, float* __restrict__ T_lo, long long ldt,
                        int B, int n, int m, int strips) {
    using lk_tc::cp_async;
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    const int passes = (m + NJ - 1) / NJ, chunks = (m + KC - 1) / KC;
    const int per_strip = passes * chunks;     // (pass, chunk) steps
    const int q_begin = (int)((long long)blockIdx.x * strips / gridDim.x);
    const int q_end = (int)((long long)(blockIdx.x + 1) * strips / gridDim.x);
    const int steps = (q_end - q_begin) * per_strip;
    const size_t plane = (size_t)n * (size_t)m;

    // ---- the next step's chunks, strip lq, pass lp, chunk lc, into ring
    //      slot `slot` (one commit group, maybe empty)
    int lq = q_begin, lp = 0, lc = 0;
    auto load_next = [&](int slot) {
        if (lq < q_end) {
            const int tile = lq / B, i0 = tile * SR, b = lq - tile * B;
            const int k0 = lc * KC, j0 = lp * NJ;
            const int cols = (min(NJ, m - j0) + 8 * NG - 1) / (8 * NG) * (8 * NG);
            const float* src = U + (size_t)b * plane;
            float* const Us = smem + slot * WSTAGE;
            float* const Ms = Us + SR * LDW;
            float* const Ks = Ms + SR * LDW;
            constexpr int CPR = KC / VEC;
            for (int e = tid; e < SR * CPR; e += NTHREADS) {
                const int r = e / CPR, c = (e - r * CPR) * VEC;
                const int i = i0 + r, k = k0 + c;
                const bool ok = i < n && k < m;
                const size_t o = (size_t)i * m + k;
                cp_async<VEC>(Us + r * LDW + c, ok ? src + o : U, ok);
                cp_async<VEC>(Ms + r * LDW + c, ok ? mask + o : mask, ok);
            }
            constexpr int KPR = NJ / VEC;
            for (int e = tid; e < KC * KPR; e += NTHREADS) {
                const int r = e / KPR, c = (e - r * KPR) * VEC;
                if (c >= cols) continue;
                const int k = k0 + r, j = j0 + c;
                const bool ok = k < m && j < m;
                cp_async<VEC>(Ks + r * LDB + c, ok ? K2 + (size_t)k * ldk2 + j : K2, ok);
            }
            if (++lc == chunks) {
                lc = 0;
                if (++lp == passes) {
                    lp = 0;
                    ++lq;
                }
            }
        }
        lk_tc::cp_async_commit();
    };

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < WSTAGES - 1; ++t) load_next(t);
    int q = q_begin, p = 0, c = 0;             // the step computed
    for (int st = 0; st < steps; ++st) {
        const int s = st % WSTAGES;
        lk_tc::cp_async_wait<WSTAGES - 2>();
        __syncthreads();   // step st landed; step st - 1 is done with the ring
        load_next((st + WSTAGES - 1) % WSTAGES);
        const int k0 = c * KC, j0 = p * NJ;
        const int nt_n = (min(NJ, m - j0) + 7) / 8;
        const int groups = (nt_n + NG - 1) / NG;
        if (c == 0) {
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        }
        const float* const Ur = smem + s * WSTAGE + (warp * 16 + gid) * LDW;
        const float* const Mr = Ur + SR * LDW;
        const float* const Ks = smem + s * WSTAGE + 2 * SR * LDW;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8) {
            if (k0 + kk >= m) break;
            // A: (row gid, k tig), (gid + 8, tig), (gid, tig + 4), (gid + 8,
            // tig + 4), masked on the way in
            uint32_t ah[4], al[4];
            split_alu(Ur[kk + tig] * Mr[kk + tig], ah[0], al[0]);
            split_alu(Ur[8 * LDW + kk + tig] * Mr[8 * LDW + kk + tig], ah[1], al[1]);
            split_alu(Ur[kk + tig + 4] * Mr[kk + tig + 4], ah[2], al[2]);
            split_alu(Ur[8 * LDW + kk + tig + 4] * Mr[8 * LDW + kk + tig + 4], ah[3],
                         al[3]);
            // B: (k tig, j gid) and (k tig + 4, j gid) of each 8-column block.
            // The fragments go in groups of NG with no branch inside a
            // group, so that the compiler interleaves their MMA chains (a
            // test per fragment kept one chain in flight); the columns of
            // the last group past m are zeros.
            const float* const Kr = Ks + (kk + tig) * LDB + gid;
#pragma unroll
            for (int g = 0; g < NT / NG; ++g) {
                if (g >= groups) break;
#pragma unroll
                for (int u = 0; u < NG; ++u) {
                    const int t = g * NG + u;
                    uint32_t h0, l0, h1, l1;
                    split_alu(Kr[t * 8], h0, l0);
                    split_alu(Kr[4 * LDB + t * 8], h1, l1);
                    float d[4] = {0.f, 0.f, 0.f, 0.f};
                    lk_tc::mma_tf32(d, al, h0, h1);
                    lk_tc::mma_tf32(d, ah, l0, l1);
                    lk_tc::mma_tf32(d, ah, h0, h1);
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[t][e] += d[e];
                }
            }
        }
        if (c == chunks - 1) {
            // ---- the pass's columns of the warp's 16 rows, out as TF32
            //      halves: for each column (b, j), 8 consecutive rows
            const int tile = q / B, b = q - tile * B;
            const int r0 = tile * SR + warp * 16 + gid;
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                if (t >= nt_n) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = r0 + 8 * (e >> 1), j = j0 + t * 8 + 2 * tig + (e & 1);
                    if (i >= n || j >= m) continue;
                    uint32_t h, l;
                    split_alu(acc[t][e], h, l);
                    const size_t o = ((size_t)b * m + j) * (size_t)ldt + i;
                    T_hi[o] = __uint_as_float(h);
                    T_lo[o] = __uint_as_float(l);
                }
            }
        }
        if (++c == chunks) {
            c = 0;
            if (++p == passes) {
                p = 0;
                ++q;
            }
        }
    }
}

}  // namespace lk_two_stage

// Launches stage R on `stream` with the grid of `plan` (the wrapper's
// planner): plan->blocks persistent blocks over plan->strips strips, T
// written as two planes T_hi, T_lo of (B m) rows with row stride ldt >= n.
// Returns the CUDA error code of the launch (0 = success;
// cudaErrorInvalidValue for a plan that does not cover the rows). Does not
// synchronise and allocates nothing.
extern "C" int lk_mvm_stage_right_launch(const void* U, const void* mask,
                                         const void* K2, long long ldk2,
                                         void* T_hi, void* T_lo, long long ldt,
                                         int B, int n, int m,
                                         const lk_two_stage::StreamPlan* plan,
                                         void* stream) {
    using namespace lk_two_stage;
    if (B <= 0 || n <= 0 || m <= 0 || ldt < n) return (int)cudaErrorInvalidValue;
    if (plan->strip_rows != SR
        || (long long)plan->strips != (long long)B * ((n + SR - 1) / SR)
        || plan->blocks < 1 || plan->blocks > plan->strips)
        return (int)cudaErrorInvalidValue;
    const bool wide = m > KR_MAX;
    // The wide kernel copies the mask and K2 with cp.async too: 16 bytes
    // only where all three operands' rows are 16-byte aligned.
    const bool vec4 = (uintptr_t)U % 16 == 0 && m % 4 == 0
        && (!wide || ((uintptr_t)mask % 16 == 0 && (uintptr_t)K2 % 16 == 0
                      && ldk2 % 4 == 0));
    const bool full = m > 48 && m <= KR_MAX;
    void (*kernel)(const float*, const float*, const float*, long long, float*, float*,
                   long long, int, int, int, int) =
        wide ? (vec4 ? stage_right_kernel_wide<4> : stage_right_kernel_wide<1>)
        : vec4 ? (full ? stage_right_kernel<4, true> : stage_right_kernel<4, false>)
               : (full ? stage_right_kernel<1, true> : stage_right_kernel<1, false>);
    // Over 48 KB of dynamic shared memory has to be asked for, once per
    // instantiation and device. (Two threads racing here set the same value.)
    constexpr int MAX_DEVICES = 64;
    static bool smem_set[6][MAX_DEVICES] = {};
    const int which = wide ? 4 + !vec4 : 2 * !vec4 + !full;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || !smem_set[which][dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        if (err != cudaSuccess) return (int)err;
        if (dev < MAX_DEVICES) smem_set[which][dev] = true;
    }
    kernel<<<plan->blocks, NTHREADS, BYTES, (cudaStream_t)stream>>>(
        (const float*)U, (const float*)mask, (const float*)K2, ldk2, (float*)T_hi,
        (float*)T_lo, ldt, B, n, m, plan->strips);
    return (int)cudaGetLastError();
}

// The runtime's view of the instantiations the launcher picks from, at its
// launch: which = 0 16-byte copies and 48 < m <= 64, 1 16-byte m <= 48,
// 2 4-byte 48 < m <= 64, 3 4-byte m <= 48, 4 16-byte m > 64 (wide), 5 4-byte
// m > 64 (the order of kernels/budget.py's entries).
extern "C" int lk_mvm_two_stage_attributes(int which, KernelAttr* out) {
    using lk_two_stage::stage_right_kernel;
    using lk_two_stage::stage_right_kernel_wide;
    constexpr int threads = lk_two_stage::NTHREADS, bytes = lk_two_stage::BYTES;
    switch (which) {
    case 0: return kernel_attributes(stage_right_kernel<4, true>, threads, bytes, out);
    case 1: return kernel_attributes(stage_right_kernel<4, false>, threads, bytes, out);
    case 2: return kernel_attributes(stage_right_kernel<1, true>, threads, bytes, out);
    case 3: return kernel_attributes(stage_right_kernel<1, false>, threads, bytes, out);
    case 4: return kernel_attributes(stage_right_kernel_wide<4>, threads, bytes, out);
    case 5: return kernel_attributes(stage_right_kernel_wide<1>, threads, bytes, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// Human-readable name of an error code returned by the launch function.
extern "C" const char* lk_mvm_two_stage_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
