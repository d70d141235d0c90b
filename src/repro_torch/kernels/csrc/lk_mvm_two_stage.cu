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
// only block-wide barrier per strip is the ring's. m > 64 sweeps 64-column
// chunks of the reduction and 64-column output tiles, reloading K2's and the
// mask's chunk per step. Each k step's three MMAs go into a zeroed fragment
// that a rounding FADD adds to the output fragment, as in K1's stage R:
// accumulating the 24 MMAs of m = 64 in place let the tensor cores'
// truncation bias T toward zero by ~5e-7 of itself, ten times the bias of
// this order (emulated in tests/test_torch_kernels.py), and CG solutions
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

// FULL: 48 < m <= 64 (the main shapes), one 64-wide column tile and chunk,
// so the tile width and every loop bound are compile-time constants.
template <int VEC, bool FULL>
__global__ void __launch_bounds__(NTHREADS, 2)
stage_right_kernel(const float* __restrict__ U, const float* __restrict__ mask,
                   const float* __restrict__ K2, long long ldk2,
                   float* __restrict__ T_hi, float* __restrict__ T_lo, long long ldt,
                   int B, int n, int m, int strips) {
    using lk_tc::cp_async;
    extern __shared__ __align__(16) float smem[];
    float* const M_s = smem + STAGES * SLOT;   // [r][mm] mask tile
    float* const k2t = M_s + SLOT;             // [j][mm][hi, lo] K2^T chunk

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;
    // The output column tile is also the reduction chunk: all of m (rounded
    // up to 16) when m <= 64, else 64.
    const int JT = FULL ? KR_MAX : m <= KR_MAX ? (m + 15) / 16 * 16 : KR_MAX;
    const int LDU = (JT + 31) / 32 * 32 + 8;
    const int jtiles = FULL ? 1 : (m + JT - 1) / JT, jq_n = JT / 16;
    const int per_strip = jtiles * jtiles;     // (column tile, chunk) steps
    const bool resident = per_strip == 1;
    const int q_begin = (int)((long long)blockIdx.x * strips / gridDim.x);
    const int q_end = (int)((long long)(blockIdx.x + 1) * strips / gridDim.x);
    const int steps = (q_end - q_begin) * per_strip;
    const size_t plane = (size_t)n * (size_t)m;

    auto U_s = [&](int s) { return smem + s * SLOT; };

    // ---- U rows of the next step to load, strip lq and (column tile,
    //      chunk) lw, into ring slot `slot` (one commit group, maybe empty).
    //      Steps advance by counters, not by 64-bit divisions of a step index.
    int lq = q_begin, lw = 0;
    auto load_next = [&](int slot) {
        if (lq < q_end) {
            const int tile = lq / B, ch = lw % jtiles;
            const int i0 = tile * SR, b = lq - tile * B;
            const float* src = U + (size_t)b * plane;
            float* dst = U_s(slot);
            const int c0 = ch * JT, cpr = JT / VEC;
            for (int e = tid; e < SR * cpr; e += NTHREADS) {
                const int r = e / cpr, c = (e - r * cpr) * VEC;
                const int i = i0 + r, gc = c0 + c;
                const bool ok = i < n && gc < m;
                cp_async<VEC>(dst + r * LDU + c,
                              ok ? src + (size_t)i * m + gc : U, ok);
            }
            if (++lw == per_strip) {
                lw = 0;
                ++lq;
            }
        }
        lk_tc::cp_async_commit();
    };
    // The mask tile of row tile i0 / SR, chunk ch, and K2^T[j][mm] =
    // K2[c0 + mm][j0 + j] split into TF32 halves: plain loads, neighbouring
    // threads on neighbouring columns, each thread's EACH loads all issued
    // before the first is used (one round trip to L2, not EACH in a row).
    constexpr int EACH = SR * KR_MAX / NTHREADS;
    static_assert(EACH * NTHREADS == KR_MAX * KR_MAX, "K2^T and mask tiles alike");
    auto load_mask = [&](int i0, int ch) {
        const int c0 = ch * JT;
        float v[EACH];
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, r = e / JT, c = e - r * JT;
            const int i = i0 + r, gc = c0 + c;
            v[k] = e < SR * JT && i < n && gc < m ? mask[(size_t)i * m + gc] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, r = e / JT, c = e - r * JT;
            if (e < SR * JT) M_s[r * LDU + c] = v[k];
        }
    };
    auto load_k2t = [&](int jt, int ch) {
        const int j0 = jt * JT, c0 = ch * JT;
        float v[EACH];
#pragma unroll
        for (int k = 0; k < EACH; ++k) {
            const int e = tid + k * NTHREADS, jl = e % JT, mm = e / JT;
            const int gj = j0 + jl, gm = c0 + mm;
            v[k] = e < JT * JT && gj < m && gm < m ? K2[(size_t)gm * ldk2 + gj] : 0.f;
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
    if (resident && q_begin < q_end) {   // under the first strips' copies
        load_k2t(0, 0);                  // for the whole launch
        mask_i0 = q_begin / B * SR;
        load_mask(mask_i0, 0);
    }
    int q = q_begin - 1, w = per_strip - 1;   // the step computed: strip q, w
    for (int st = 0; st < steps; ++st) {
        if (++w == per_strip) {
            w = 0;
            ++q;
        }
        const int s = st % STAGES, jt = w / jtiles, ch = w - jt * jtiles;
        const int tile = q / B, i0 = tile * SR, b = q - tile * B;
        lk_tc::cp_async_wait<STAGES - 2>();
        __syncthreads();   // step st landed; step st - 1 is done with the ring
        load_next((st + STAGES - 1) % STAGES);
        if (!resident || i0 != mask_i0) {
            if (!resident) load_k2t(jt, ch);
            load_mask(i0, ch);
            mask_i0 = i0;
            __syncthreads();
        }
        if (ch == 0) {
#pragma unroll
            for (int jq = 0; jq < JQ_MAX; ++jq)
#pragma unroll
                for (int f = 0; f < 2; ++f)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[jq][f][e] = 0.f;
        }
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
        if (ch != jtiles - 1) continue;

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
        const int j0 = jt * JT;
        for (int e = lane; e < 16 * JT; e += 32) {
            const int jl = e >> 4, r = e & 15;
            const int i = i0 + warp * 16 + r, gj = j0 + jl;
            if (i >= n || gj >= m) continue;
            uint32_t h, l;
            lk_tc::split(Ts[jl * LDTS + r], h, l);
            const size_t o = ((size_t)b * m + gj) * (size_t)ldt + i;
            T_hi[o] = __uint_as_float(h);
            T_lo[o] = __uint_as_float(l);
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
    const bool vec4 = (uintptr_t)U % 16 == 0 && m % 4 == 0;
    const bool full = m > 48 && m <= KR_MAX;
    void (*kernel)(const float*, const float*, const float*, long long, float*, float*,
                   long long, int, int, int, int) =
        vec4 ? (full ? stage_right_kernel<4, true> : stage_right_kernel<4, false>)
             : (full ? stage_right_kernel<1, true> : stage_right_kernel<1, false>);
    // Over 48 KB of dynamic shared memory has to be asked for, once per
    // instantiation and device. (Two threads racing here set the same value.)
    constexpr int MAX_DEVICES = 64;
    static bool smem_set[4][MAX_DEVICES] = {};
    const int which = 2 * full + vec4;
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
// launch: which = 0 16-byte copies and 48 < m <= 64, 1 16-byte other m,
// 2 4-byte 48 < m <= 64, 3 4-byte other m (the order of kernels/budget.py's
// entries).
extern "C" int lk_mvm_two_stage_attributes(int which, KernelAttr* out) {
    using lk_two_stage::stage_right_kernel;
    switch (which) {
    case 0: return kernel_attributes(stage_right_kernel<4, true>, lk_two_stage::NTHREADS,
                                     lk_two_stage::BYTES, out);
    case 1: return kernel_attributes(stage_right_kernel<4, false>, lk_two_stage::NTHREADS,
                                     lk_two_stage::BYTES, out);
    case 2: return kernel_attributes(stage_right_kernel<1, true>, lk_two_stage::NTHREADS,
                                     lk_two_stage::BYTES, out);
    case 3: return kernel_attributes(stage_right_kernel<1, false>, lk_two_stage::NTHREADS,
                                     lk_two_stage::BYTES, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// Human-readable name of an error code returned by the launch function.
extern "C" const char* lk_mvm_two_stage_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
