// Causal GQA flash attention (prefill), bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel _flash_kernel / flash_attention_p in
// src/repro/kernels/flash_attention/kernel.py.  What it computes is the
// same: blockwise online softmax over key blocks, the G query heads of one
// KV head folded into the rows of the q tile (so a K/V block is read once
// for all G heads), optional sliding window and q_offset, key blocks outside
// [kv_begin, kv_end) never visited, a row no key may attend to giving 0;
// f32 scores, and probabilities rounded to bf16 before the PV product.
//
// Bound on the H100: at smollm-360m's serving shape (one 512-token prompt,
// 15 heads over 5 KV heads, head_dim 64) the function moves ~2.6 MB against
// ~0.25 GFLOP of causal products, so bytes bound it (~0.8 us); at
// recurrentgemma-2b's prefill (4 x 3072 tokens, 10 heads over 1 KV head,
// head_dim 256, window 2048) it needs ~1.7e11 FLOP on the band, so the
// tensor cores bound it (~0.17 ms).
//
// Design (Hopper tensor cores):
// * Grid (ceil(S / bq), B * KH); 256 threads = two warpgroups of 64 q rows.
//   Warpgroup w holds qw = 64 / G queries of block s0: row r is query
//   s0 + w * qw + r / G, head kh * G + r % G.  Both warpgroups share every
//   K/V stage, so a K/V block is read once for 2 * qw * G rows.
// * Q is loaded once, bf16, by TMA: a 4-D map over (H, N, S, B) with box
//   (64, G, qw, 1) lands exactly those rows, 64 columns a slab.  K and V go
//   through a ring of 2-4 stages of 64 keys: 4-D maps over (H, KH, T, B)
//   with box (64, 1, 64, 1), so keys past T read as zeros for each batch
//   row.  A `full` mbarrier per slot counts a stage's bytes; an `empty` one
//   per slot counts the eight consumer warps that are done with it.  Thread
//   0 refills a slot only once it is empty.
// * S = Q K^T is H / 16 wgmma m64n64k16, both operands K-major in shared
//   memory.  The mask is applied in registers from each accumulator
//   element's (row, key) coordinates, only in blocks that need it.  The
//   online softmax runs in registers: a row lives in one quad of the
//   accumulator layout, so its max and sum take two __shfl_xor.
// * P is rounded to bf16 in registers and is the register A operand of
//   wgmma m64nHk16 against V, MN-major (the transpose bit).
#include "hopper.cuh"

namespace {

constexpr int WG_ROWS = 64;          // q rows per consumer warpgroup
constexpr int WGS = 2;               // consumer warpgroups per block
constexpr int THREADS = 128 * WGS;
constexpr int BKV = 64;              // keys per ring stage
constexpr int SLAB = 64 * 128;       // 64 rows of 64 bf16 columns (128 bytes)
constexpr uint32_t ALIGN = 1024;     // the swizzle atom

// K/V ring stages: as deep as shared memory allows at one block per SM
// (two at H = 64, whose registers allow two blocks)
template <int H>
constexpr int stages_of() { return H == 64 ? 4 : (H == 128 ? 3 : 2); }

template <int H>
struct Smem {
    static constexpr int STAGES = stages_of<H>();
    static constexpr int SLABS = H / 64;
    static constexpr size_t q_bytes = (size_t)WGS * WG_ROWS * H * 2;  // [wg][slab][64 rows]
    static constexpr size_t kv_bytes = (size_t)BKV * H * 2;            // K or V: [slab][64 keys]
    static constexpr size_t stage_bytes = 2 * kv_bytes;               // K then V
    static constexpr size_t stage_off = q_bytes;
    static constexpr size_t bar_off = stage_off + (size_t)STAGES * stage_bytes;
    static constexpr int n_bars = 1 + 2 * STAGES;                     // q, full[], empty[]
    static constexpr size_t bytes = ALIGN + bar_off + n_bars * sizeof(uint64_t);
};

// May query position qp attend to key position kpos?
__device__ __forceinline__ bool valid(int qp, int kpos, int T, int causal, int window) {
    bool ok = kpos < T;
    if (causal) ok = ok && kpos <= qp;
    if (window) ok = ok && kpos > qp - window;
    return ok;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// O (64 x H) += P (64 x 16, registers) V (16 x H, MN-major)
template <int H>
__device__ __forceinline__ void pv_product(float (&o)[H / 2], const uint32_t (&a)[4], uint64_t desc_v) {
    if constexpr (H == 64) hopper::wgmma_m64n64k16_rs<1>(o, a, desc_v, 1);
    else if constexpr (H == 128) hopper::wgmma_m64n128k16_rs<1>(o, a, desc_v, 1);
    else hopper::wgmma_m64n256k16_rs<1>(o, a, desc_v, 1);
}

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                       int S, int T, int N, int KH, int causal, int window, int q_offset,
                       float scale_log2) {
    using L = Smem<H>;
    constexpr int SLABS = L::SLABS, STAGES = L::STAGES;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
    uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::bar_off);
    uint64_t* full = qbar + 1;
    uint64_t* empty = full + STAGES;

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int G = N / KH, qw = WG_ROWS / G, bq = WGS * qw;
    const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
    const int s0 = blockIdx.x * bq;
    const int s_end = min(s0 + bq, S);

    // key blocks this q block can see: up to the diagonal, after the window
    const int q_first = q_offset + s0, q_last = q_offset + s_end - 1;
    const int kv_end = causal ? min(T, q_last + 1) : T;
    const int kv_begin = window ? max(0, q_first - window + 1) : 0;
    const int j_begin = kv_begin / BKV;
    const int j_end = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

    if (tid == 0) {
        hopper::mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], WGS * 4);  // one arrival per consumer warp
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    // key block j -> slot (j - j_begin) % STAGES; its u-th fill waits for
    // the (u - 1)-th release (thread 0 only)
    auto issue_kv = [&](int j) {
        const int i = j - j_begin, slot = i % STAGES, use = i / STAGES;
        if (use > 0) hopper::mbar_wait(&empty[slot], (use - 1) & 1);
        unsigned char* st = smem + L::stage_off + slot * L::stage_bytes;
        hopper::mbar_arrive_expect_tx(&full[slot], (uint32_t)L::stage_bytes);
#pragma unroll
        for (int c = 0; c < SLABS; ++c) {
            hopper::tma_load_4d(st + c * SLAB, &mk, &full[slot], 64 * c, kh, j * BKV, b);
            hopper::tma_load_4d(st + L::kv_bytes + c * SLAB, &mv, &full[slot], 64 * c, kh, j * BKV, b);
        }
    };
    if (tid == 0) {
        hopper::mbar_arrive_expect_tx(qbar, (uint32_t)(WGS * SLABS * qw * G * 128));
        for (int w = 0; w < WGS; ++w)
#pragma unroll
            for (int c = 0; c < SLABS; ++c)
                hopper::tma_load_4d(smem + (w * SLABS + c) * SLAB, &mq, qbar, 64 * c, kh * G,
                                    s0 + w * qw, b);
        for (int j = j_begin; j < min(j_end, j_begin + STAGES - 1); ++j) issue_kv(j);
    }
    __syncwarp();

    // this thread's two rows of its warpgroup: r and r + 8
    const int r_lo = warp * 16 + lane / 4;
    int qp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qp[h] = q_offset + s0 + wg * qw + (r_lo + 8 * h) / G;

    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l_run[2] = {0.f, 0.f};
    const unsigned char* qs = smem + wg * SLABS * SLAB;

    hopper::mbar_wait(qbar, 0);
    for (int j = j_begin; j < j_end; ++j) {
        if (tid == 0 && j + STAGES - 1 < j_end) issue_kv(j + STAGES - 1);
        __syncwarp();
        const int i = j - j_begin, slot = i % STAGES;
        hopper::mbar_wait(&full[slot], (i / STAGES) & 1);
        const unsigned char* ks = smem + L::stage_off + slot * L::stage_bytes;
        const unsigned char* vs = ks + L::kv_bytes;

        // S = Q K^T over H in steps of 16
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        hopper::fence_regs(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
            const int off = (kk / 4) * SLAB + (kk % 4) * 32;
            hopper::wgmma_m64n64k16_ss<0>(s, hopper::desc_sw128(qs + off, 16, 1024),
                                          hopper::desc_sw128(ks + off, 16, 1024), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        // scores in the log2 domain; s[4 jn + e] is row r_lo + 8 (e / 2),
        // key j * BKV + 8 jn + 2 (lane % 4) + e % 2
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
        const bool unmasked = (j + 1) * BKV <= T && (!causal || (j + 1) * BKV - 1 <= q_first) &&
                              (!window || j * BKV > q_last - window);
        if (!unmasked) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int kpos = j * BKV + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
                if (!valid(qp[(e % 4) / 2], kpos, T, causal, window)) s[e] = REPRO_NEG_INF;
            }
        }

        // online softmax: a row's four owners are one quad of lanes
        float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int e = 0; e < 32; ++e) m_new[(e % 4) / 2] = fmaxf(m_new[(e % 4) / 2], s[e]);
        float m_use[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            m_new[h] = quad_max(m_new[h]);
            // a row masked so far keeps its zeros: exp2(NEG_INF - 0) = 0
            m_use[h] = m_new[h] == REPRO_NEG_INF ? 0.f : m_new[h];
            alpha[h] = exp2f(m_run[h] - m_use[h]);
            m_run[h] = m_new[h];
        }
        uint32_t p[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const int h = r % 2;  // fragment register r holds row r_lo + 8 (r % 2)
            const float lo = exp2f(s[2 * r] - m_use[h]), hi = exp2f(s[2 * r + 1] - m_use[h]);
            rsum[h] += lo + hi;
            p[r] = hopper::pack_bf16x2(lo, hi);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_run[h] = alpha[h] * l_run[h] + quad_sum(rsum[h]);
#pragma unroll
        for (int e = 0; e < H / 2; ++e) acc[e] *= alpha[(e % 4) / 2];

        // O += P V over the block's 64 keys in steps of 16
        hopper::fence_regs(acc);
        hopper::fence_regs(p);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
            pv_product<H>(acc, a, hopper::desc_sw128(vs + kk * 2048, SLAB, 1024));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[slot]);  // this warp is done with the slot
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        const int s = s0 + wg * qw + r / G;
        if (r < qw * G && s < S) {
            const float inv = l_run[h] == 0.f ? 1.f : 1.f / l_run[h];  // a fully masked row gives 0
            bf16* orow = o + ((size_t)(b * S + s) * N + kh * G + r % G) * H + 2 * (lane % 4);
#pragma unroll
            for (int jn = 0; jn < H / 8; ++jn)
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jn) =
                    __floats2bfloat162_rn(acc[4 * jn + 2 * h] * inv, acc[4 * jn + 2 * h + 1] * inv);
        }
    }
}

template <int H>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int N, int KH,
           int causal, int window, int q_offset, float sm_scale, cudaStream_t stream) {
    const int G = N / KH, qw = WG_ROWS / G, bq = WGS * qw;
    if (T == 0)  // no key at all: every row gives 0
        return (int)cudaMemsetAsync(o, 0, (size_t)B * S * N * H * sizeof(bf16), stream);
    CUtensorMap mq, mk, mv;
    const uint64_t q_dims[4] = {(uint64_t)H, (uint64_t)N, (uint64_t)S, (uint64_t)B};
    const uint64_t q_strides[3] = {(uint64_t)H * 2, (uint64_t)N * H * 2, (uint64_t)S * N * H * 2};
    const uint32_t q_box[4] = {64, (uint32_t)G, (uint32_t)qw, 1};
    int rc = hopper::encode_bf16_map(&mq, q, 4, q_dims, q_strides, q_box);
    if (rc) return rc;
    const uint64_t kv_dims[4] = {(uint64_t)H, (uint64_t)KH, (uint64_t)T, (uint64_t)B};
    const uint64_t kv_strides[3] = {(uint64_t)H * 2, (uint64_t)KH * H * 2, (uint64_t)T * KH * H * 2};
    const uint32_t kv_box[4] = {64, 1, BKV, 1};
    if ((rc = hopper::encode_bf16_map(&mk, k, 4, kv_dims, kv_strides, kv_box))) return rc;
    if ((rc = hopper::encode_bf16_map(&mv, v, 4, kv_dims, kv_strides, kv_box))) return rc;

    const size_t smem = Smem<H>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    const dim3 grid((S + bq - 1) / bq, B * KH);
    flash_attention_kernel<H><<<grid, THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), S, T, N, KH, causal, window, q_offset,
        sm_scale * 1.4426950408889634f);
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block takes at head dim H (0: not a kernel's H).
extern "C" int repro_flash_attention_smem_bytes(int H) {
    switch (H) {
        case 64: return (int)Smem<64>::bytes;
        case 128: return (int)Smem<128>::bytes;
        case 256: return (int)Smem<256>::bytes;
        default: return 0;
    }
}

// q (B, S, N, H), k/v (B, T, KH, H), o (B, S, N, H): contiguous bf16,
// 16-byte aligned.  Returns the launch's cudaGetLastError() code (or the
// tensor maps' encoding error).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int T, int N, int KH, int H,
                                          int causal, int window, int q_offset,
                                          float sm_scale, void* stream) {
    if (KH <= 0 || N % KH != 0 || N / KH > WG_ROWS || B <= 0 || S <= 0 || T < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (H) {
        case 64:
            return launch<64>(q, k, v, o, B, S, T, N, KH, causal, window, q_offset, sm_scale, st);
        case 128:
            return launch<128>(q, k, v, o, B, S, T, N, KH, causal, window, q_offset, sm_scale, st);
        case 256:
            return launch<256>(q, k, v, o, B, S, T, N, KH, causal, window, q_offset, sm_scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
