// GQA decode attention: one query token per sequence against its KV cache,
// bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel _decode_kernel / decode_attention_p in
// src/repro/kernels/decode_attention/kernel.py.  What it computes is the
// same: one block per (batch, KV head) holding the G query heads of that KV
// head; the cache stays in device memory, passed by reference, and only
// ceil(length / BKV) key blocks are fetched (the trip count is read from
// the lengths array); the blocks stream through a ring of `slots` shared-
// memory stages filled `distance` blocks ahead by cp.async (distance 0:
// fetch, then wait), with online softmax over the blocks.  The arithmetic
// does not depend on the ring, so every PrefetchSpec gives the same bits.
//
// Bound on the H100: each step must read the valid prefix of K and V once
// (4 sequences x ~530 rows x 5 KV heads x 64 x 2 B x 2 = ~1.4 MB per layer
// on the serving path, ~0.4 us at 3.35 TB/s) for ~2.7 MFLOP, so bytes bound
// it.  The design reads the (B, T, KH, H) cache in place (the TPU wrapper
// transposed and padded a copy of it), fetches no row past the length, and
// reads each K/V row once for all G heads.  At batch 4 it launches only
// B * KH = 20 blocks on 132 SMs, so it cannot draw the card's full memory
// rate: splitting the key axis across blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int BKV = 64;      // key rows per ring stage
constexpr int MAXG = 16;     // query heads per KV head

// threads per block: 128, or one per column of the head where H > 128 (the
// PV product gives each thread one column; every output's sums run in one
// order whatever the block size, so H = 64 and 128 keep their bits)
template <int H>
constexpr int threads_of() { return H > 128 ? H : 128; }

template <int H>
struct Smem {
    static constexpr int KSTRIDE = H + 8;  // padded K row: 16-byte reads hit distinct banks
    // K ring bf16 [slots][BKV][KSTRIDE], V ring bf16 [slots][BKV][H], then
    // f32 q [MAXG][H], scores [MAXG][BKV], m / l / alpha [MAXG]
    static size_t bytes(int slots) {
        return (size_t)slots * BKV * (KSTRIDE + H) * 2 + (MAXG * H + MAXG * BKV + 3 * MAXG) * 4;
    }
};

template <int H, int THREADS = threads_of<H>()>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ lengths,
                        bf16* __restrict__ o, int T, int N, int KH, int distance, int slots,
                        float sm_scale) {
    constexpr int KS = Smem<H>::KSTRIDE;
    constexpr int CPR = H / 8;                  // 16-byte chunks per row
    constexpr int RSTEP = THREADS / H;          // PV: heads between a thread's outputs
    constexpr int NACC = MAXG / RSTEP;          // PV: outputs per thread
    constexpr int KSPLIT = THREADS / BKV;       // scores: threads per key
    constexpr int SHEADS = MAXG / KSPLIT;       // scores: heads per thread

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Kr = reinterpret_cast<bf16*>(smem);
    bf16* Vr = Kr + (size_t)slots * BKV * KS;
    float* Qs = reinterpret_cast<float*>(Vr + (size_t)slots * BKV * H);
    float* Ss = Qs + MAXG * H;
    float* Ms = Ss + MAXG * BKV;
    float* Ls = Ms + MAXG;
    float* As = Ls + MAXG;

    const int tid = threadIdx.x;
    const int G = N / KH;
    const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
    const int len = max(0, min(lengths[b], T));
    const int needed = (len + BKV - 1) / BKV;  // dynamic trip count

    // block i -> ring slot i % slots; rows past the length are zero-filled,
    // not read.  Every call commits one group, empty past the last block, so
    // that block i is always the group `distance` before the newest one.
    auto issue = [&](int i) {
        if (i < needed) {
            const int slot = i % slots, t0 = i * BKV;
            for (int idx = tid; idx < BKV * CPR; idx += THREADS) {
                const int r = idx / CPR, c = (idx % CPR) * 8;
                const int t = t0 + r;
                const bool ok = t < len;
                const size_t off = ((size_t)(b * T + (ok ? t : 0)) * KH + kh) * H + c;
                cp_async_16(Kr + ((size_t)slot * BKV + r) * KS + c, k + off, ok ? 16 : 0);
                cp_async_16(Vr + ((size_t)slot * BKV + r) * H + c, v + off, ok ? 16 : 0);
            }
        }
        cp_async_commit();
    };

    for (int i = 0; i < distance; ++i) issue(i);  // warm the ring

    for (int idx = tid; idx < G * H; idx += THREADS)
        Qs[idx] = __bfloat162float(q[((size_t)b * N + kh * G) * H + idx]);
    for (int g = tid; g < MAXG; g += THREADS) {
        Ms[g] = REPRO_NEG_INF;
        Ls[g] = 0.f;
    }

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const int col = tid % H, rg = tid / H;

    for (int i = 0; i < needed; ++i) {
        issue(i + distance);
        cp_async_wait_n(distance);  // block i has landed
        __syncthreads();
        const int slot = i % slots;

        // scores: thread owns key kj and heads half, half + KSPLIT, ...
        {
            const int kj = tid % BKV, half = tid / BKV;
            float sacc[SHEADS];
#pragma unroll
            for (int a = 0; a < SHEADS; ++a) sacc[a] = 0.f;
            const bf16* krow = Kr + ((size_t)slot * BKV + kj) * KS;
#pragma unroll 2
            for (int c = 0; c < H; c += 8) {
                float kf[8];
                unpack_bf16x8(krow + c, kf);
#pragma unroll
                for (int a = 0; a < SHEADS; ++a)
                    if (half + KSPLIT * a < G)
                        sacc[a] = dot8(Qs + (half + KSPLIT * a) * H + c, kf, sacc[a]);
            }
            const bool ok = i * BKV + kj < len;
#pragma unroll
            for (int a = 0; a < SHEADS; ++a) {
                const int g = half + KSPLIT * a;
                if (g < G) Ss[g * BKV + kj] = ok ? sacc[a] * sm_scale : REPRO_NEG_INF;
            }
        }
        __syncthreads();

        // online softmax: one warp per head
        {
            const int warp = tid / 32, lane = tid % 32;
            for (int g = warp; g < G; g += THREADS / 32) {
                const float x0 = Ss[g * BKV + lane], x1 = Ss[g * BKV + lane + 32];
                const bool v0 = i * BKV + lane < len, v1 = i * BKV + lane + 32 < len;
                const float m_prev = Ms[g], l_prev = Ls[g];
                const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
                const float p0 = v0 ? expf(x0 - m_new) : 0.f;
                const float p1 = v1 ? expf(x1 - m_new) : 0.f;
                const float alpha = expf(m_prev - m_new);
                const float l_new = alpha * l_prev + warp_sum(p0 + p1);
                Ss[g * BKV + lane] = round_bf16(p0);
                Ss[g * BKV + lane + 32] = round_bf16(p1);
                __syncwarp();  // every lane has read Ms/Ls[g] before lane 0 writes
                if (lane == 0) {
                    Ms[g] = m_new;
                    Ls[g] = l_new;
                    As[g] = alpha;
                }
            }
        }
        __syncthreads();

        // acc = acc * alpha + P @ V; thread owns column col of heads rg, rg + RSTEP, ...
        {
#pragma unroll
            for (int a = 0; a < NACC; ++a) {
                const int g = rg + a * RSTEP;
                if (g < G) acc[a] *= As[g];
            }
            const bf16* vcol = Vr + (size_t)slot * BKV * H + col;
            for (int jj = 0; jj < BKV; jj += 4) {
                const float w0 = __bfloat162float(vcol[(jj + 0) * H]);
                const float w1 = __bfloat162float(vcol[(jj + 1) * H]);
                const float w2 = __bfloat162float(vcol[(jj + 2) * H]);
                const float w3 = __bfloat162float(vcol[(jj + 3) * H]);
#pragma unroll
                for (int a = 0; a < NACC; ++a) {
                    const int g = rg + a * RSTEP;
                    if (g < G) {
                        const float4 p = *reinterpret_cast<const float4*>(Ss + g * BKV + jj);
                        acc[a] = fmaf(p.x, w0, acc[a]);
                        acc[a] = fmaf(p.y, w1, acc[a]);
                        acc[a] = fmaf(p.z, w2, acc[a]);
                        acc[a] = fmaf(p.w, w3, acc[a]);
                    }
                }
            }
        }
        __syncthreads();  // the slot and the scores are free for reuse
    }
    cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
    for (int a = 0; a < NACC; ++a) {
        const int g = rg + a * RSTEP;
        if (g < G) {
            float l = Ls[g];
            l = (l == 0.f) ? 1.f : l;  // length 0 gives 0
            o[((size_t)b * N + kh * G + g) * H + col] = __float2bfloat16(acc[a] / l);
        }
    }
}

template <int H>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o, int B,
           int T, int N, int KH, int distance, int slots, float sm_scale, cudaStream_t stream) {
    const size_t smem = Smem<H>::bytes(slots);
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    decode_attention_kernel<H><<<B * KH, threads_of<H>(), smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const int*>(lengths), static_cast<bf16*>(o), T, N, KH, distance, slots,
        sm_scale);
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block takes at head dim H with a ring of `slots`
// stages (0: not a kernel's H).
extern "C" int repro_decode_attention_smem_bytes(int H, int slots) {
    switch (H) {
        case 64: return (int)Smem<64>::bytes(slots);
        case 128: return (int)Smem<128>::bytes(slots);
        case 256: return (int)Smem<256>::bytes(slots);
        default: return 0;
    }
}

// q (B, N, H), k/v (B, T, KH, H) contiguous bf16; lengths (B,) int32;
// o (B, N, H).  Returns the launch's cudaGetLastError() code.
extern "C" int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* lengths, void* o, int B, int T, int N,
                                           int KH, int H, int distance, int slots,
                                           float sm_scale, void* stream) {
    if (KH <= 0 || N % KH != 0 || N / KH > MAXG || distance < 0 || slots < distance + 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (H) {
        case 64:
            return launch<64>(q, k, v, lengths, o, B, T, N, KH, distance, slots, sm_scale, st);
        case 128:
            return launch<128>(q, k, v, lengths, o, B, T, N, KH, distance, slots, sm_scale, st);
        case 256:
            return launch<256>(q, k, v, lengths, o, B, T, N, KH, distance, slots, sm_scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
