// Causal GQA flash attention (prefill), bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel _flash_kernel / flash_attention_p in
// src/repro/kernels/flash_attention/kernel.py.  What it computes is the
// same: blockwise online softmax over key blocks, the G query heads of one
// KV head folded into the rows of the q tile (so a K/V block is read once
// for all G heads), optional sliding window and q_offset, key blocks above
// the diagonal never visited, a row no key may attend to giving 0.
//
// Bound on the H100: at the serving path's shapes (one 512-token prompt,
// 15 heads over 5 KV heads, head_dim 64) the function must move ~2.6 MB
// (q, k, v read once, o written once: ~0.8 us at 3.35 TB/s) against ~0.25
// GFLOP of causal products (~0.25 us at 989 TFLOP/s), so bytes bound it.
// The design reads q/k/v in their model layouts in place (no transpose or
// padding copy, unlike the TPU wrapper), stages each K/V block through a
// cp.async double buffer in shared memory (the counterpart of Mosaic's
// implicit distance=1 pipeline) and writes o once.  The products run on the
// CUDA cores in f32: wgmma, TMA and a warp-specialised pipeline are later
// work, and so this first kernel is far from its bound.
//
// Grid: (ceil(S / bq), B * KH); block: max(128, H) threads; bq = ROWS / G
// queries.  Row r of the tile is query s0 + r / G, head kh * G + r % G.
// In the PV product each thread owns one of the H columns, so at H = 256
// the block has 256 threads; every output's sums run in one order whatever
// the block size, so H = 64 and 128 keep their 128 threads and their bits.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;     // q rows (queries x group heads) per block
constexpr int BKV = 64;      // key rows per pipeline stage

// threads per block: 128, or one per column of the head where H > 128
template <int H>
constexpr int threads_of() { return H > 128 ? H : 128; }

template <int H>
struct Smem {
    static constexpr int KSTRIDE = H + 8;  // padded K row: 16-byte reads hit distinct banks
    static constexpr size_t q_off = 0;                                  // f32 [ROWS][H]
    static constexpr size_t k_off = q_off + ROWS * H * 4;               // bf16 [2][BKV][KSTRIDE]
    static constexpr size_t v_off = k_off + 2 * BKV * KSTRIDE * 2;      // bf16 [2][BKV][H]
    static constexpr size_t s_off = v_off + 2 * BKV * H * 2;            // f32 [ROWS][BKV]
    static constexpr size_t m_off = s_off + ROWS * BKV * 4;             // f32 [ROWS] x 3
    static constexpr size_t bytes = m_off + 3 * ROWS * 4;
};

template <int H, int THREADS = threads_of<H>()>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int S, int T, int N, int KH, int causal, int window,
                       int q_offset, float sm_scale) {
    using L = Smem<H>;
    constexpr int KS = L::KSTRIDE;
    constexpr int CPR = H / 8;                  // 16-byte chunks per row
    constexpr int RSTEP = THREADS / H;          // PV: rows between a thread's outputs
    constexpr int NACC = ROWS / RSTEP;          // PV: outputs per thread
    constexpr int KSPLIT = THREADS / BKV;       // scores: threads per key
    constexpr int SROWS = ROWS / KSPLIT;        // scores: rows per thread

    extern __shared__ __align__(16) unsigned char smem[];
    float* Qs = reinterpret_cast<float*>(smem + L::q_off);
    bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
    float* Ss = reinterpret_cast<float*>(smem + L::s_off);
    float* Ms = reinterpret_cast<float*>(smem + L::m_off);
    float* Ls = Ms + ROWS;
    float* As = Ls + ROWS;

    const int tid = threadIdx.x;
    const int G = N / KH;
    const int bq = ROWS / G;
    const int rows = bq * G;
    const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
    const int s0 = blockIdx.x * bq;
    const int s_end = min(s0 + bq, S);

    // q tile -> f32 shared memory (rows past S are zeros and never stored)
    for (int idx = tid; idx < ROWS * H; idx += THREADS) {
        const int r = idx / H, c = idx % H;
        const int s = s0 + r / G;
        float val = 0.f;
        if (r < rows && s < S)
            val = __bfloat162float(q[((size_t)(b * S + s) * N + kh * G + r % G) * H + c]);
        Qs[idx] = val;
    }
    for (int r = tid; r < ROWS; r += THREADS) {
        Ms[r] = REPRO_NEG_INF;
        Ls[r] = 0.f;
    }

    // key blocks this q block can see: up to the diagonal, after the window
    const int q_first = q_offset + s0, q_last = q_offset + s_end - 1;
    const int kv_end = causal ? min(T, q_last + 1) : T;
    const int kv_begin = window ? max(0, q_first - window + 1) : 0;
    const int j_begin = kv_begin / BKV;
    const int j_end = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

    auto valid = [&](int r, int kpos) {
        const int qp = q_offset + s0 + r / G;
        bool ok = kpos < T;
        if (causal) ok = ok && kpos <= qp;
        if (window) ok = ok && kpos > qp - window;
        return ok;
    };

    auto load_kv = [&](int j, int buf) {
        const int t0 = j * BKV;
        for (int idx = tid; idx < BKV * CPR; idx += THREADS) {
            const int r = idx / CPR, c = (idx % CPR) * 8;
            const int t = t0 + r;
            const bool ok = t < T;
            const size_t off = ((size_t)(b * T + (ok ? t : 0)) * KH + kh) * H + c;
            cp_async_16(Ks + (buf * BKV + r) * KS + c, k + off, ok ? 16 : 0);
            cp_async_16(Vs + (buf * BKV + r) * H + c, v + off, ok ? 16 : 0);
        }
        cp_async_commit();
    };

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int col = tid % H, rg = tid / H;

    if (j_begin < j_end) load_kv(j_begin, 0);
    __syncthreads();

    for (int j = j_begin; j < j_end; ++j) {
        const int buf = (j - j_begin) & 1;
        if (j + 1 < j_end) {
            load_kv(j + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // scores: thread owns key kj and rows half, half + KSPLIT, ...
        {
            const int kj = tid % BKV, half = tid / BKV;
            float sacc[SROWS];
#pragma unroll
            for (int i = 0; i < SROWS; ++i) sacc[i] = 0.f;
            const bf16* krow = Ks + (buf * BKV + kj) * KS;
#pragma unroll 2
            for (int c = 0; c < H; c += 8) {
                float kf[8];
                unpack_bf16x8(krow + c, kf);
#pragma unroll
                for (int i = 0; i < SROWS; ++i)
                    if (half + KSPLIT * i < rows)
                        sacc[i] = dot8(Qs + (half + KSPLIT * i) * H + c, kf, sacc[i]);
            }
            const int kpos = j * BKV + kj;
#pragma unroll
            for (int i = 0; i < SROWS; ++i) {
                const int r = half + KSPLIT * i;
                if (r < rows) Ss[r * BKV + kj] = valid(r, kpos) ? sacc[i] * sm_scale : REPRO_NEG_INF;
            }
        }
        __syncthreads();

        // online softmax: one warp per row
        {
            const int warp = tid / 32, lane = tid % 32;
            for (int r = warp; r < rows; r += THREADS / 32) {
                const float x0 = Ss[r * BKV + lane], x1 = Ss[r * BKV + lane + 32];
                const bool v0 = valid(r, j * BKV + lane), v1 = valid(r, j * BKV + lane + 32);
                const float m_prev = Ms[r], l_prev = Ls[r];
                const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
                const float p0 = v0 ? expf(x0 - m_new) : 0.f;
                const float p1 = v1 ? expf(x1 - m_new) : 0.f;
                const float alpha = expf(m_prev - m_new);
                const float l_new = alpha * l_prev + warp_sum(p0 + p1);
                Ss[r * BKV + lane] = round_bf16(p0);
                Ss[r * BKV + lane + 32] = round_bf16(p1);
                __syncwarp();  // every lane has read Ms/Ls[r] before lane 0 writes
                if (lane == 0) {
                    Ms[r] = m_new;
                    Ls[r] = l_new;
                    As[r] = alpha;
                }
            }
        }
        __syncthreads();

        // acc = acc * alpha + P @ V; thread owns column col of rows rg, rg + RSTEP, ...
        {
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
                const int r = rg + i * RSTEP;
                if (r < rows) acc[i] *= As[r];
            }
            const bf16* vcol = Vs + buf * BKV * H + col;
            for (int jj = 0; jj < BKV; jj += 4) {
                const float w0 = __bfloat162float(vcol[(jj + 0) * H]);
                const float w1 = __bfloat162float(vcol[(jj + 1) * H]);
                const float w2 = __bfloat162float(vcol[(jj + 2) * H]);
                const float w3 = __bfloat162float(vcol[(jj + 3) * H]);
#pragma unroll
                for (int i = 0; i < NACC; ++i) {
                    const int r = rg + i * RSTEP;
                    if (r < rows) {
                        const float4 p = *reinterpret_cast<const float4*>(Ss + r * BKV + jj);
                        acc[i] = fmaf(p.x, w0, acc[i]);
                        acc[i] = fmaf(p.y, w1, acc[i]);
                        acc[i] = fmaf(p.z, w2, acc[i]);
                        acc[i] = fmaf(p.w, w3, acc[i]);
                    }
                }
            }
        }
        __syncthreads();  // the buffer and the scores are free for the next block
    }

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
        const int r = rg + i * RSTEP;
        const int s = s0 + r / G;
        if (r < rows && s < S) {
            float l = Ls[r];
            l = (l == 0.f) ? 1.f : l;  // a fully masked row gives 0
            o[((size_t)(b * S + s) * N + kh * G + r % G) * H + col] = __float2bfloat16(acc[i] / l);
        }
    }
}

template <int H>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T,
           int N, int KH, int causal, int window, int q_offset, float sm_scale,
           cudaStream_t stream) {
    const size_t smem = Smem<H>::bytes;
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    const int bq = ROWS / (N / KH);
    dim3 grid((S + bq - 1) / bq, B * KH);
    flash_attention_kernel<H><<<grid, threads_of<H>(), smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), S, T, N, KH, causal, window, q_offset, sm_scale);
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

// q (B, S, N, H), k/v (B, T, KH, H), o (B, S, N, H): contiguous bf16.
// Returns the launch's cudaGetLastError() code.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int S, int T, int N, int KH, int H,
                                          int causal, int window, int q_offset,
                                          float sm_scale, void* stream) {
    if (KH <= 0 || N % KH != 0 || N / KH > ROWS) return (int)cudaErrorInvalidValue;
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
