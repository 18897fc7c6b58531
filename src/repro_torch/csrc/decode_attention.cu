// GQA decode attention: one query token per sequence against its KV cache,
// bf16 in and out, f32 softmax state.
//
// Replaces the TPU kernel _decode_kernel / decode_attention_p in
// src/repro/kernels/decode_attention/kernel.py.  What it computes is the
// same: the G query heads of one KV head against the valid prefix
// [0, length) of a (B, T, KH, H) cache, read in place and by reference;
// f32 scores and online softmax, the probabilities rounded to bf16 before
// the product with V; a sequence of length 0 gives 0.
//
// Bound on the H100: bytes.  A step must read the valid prefix of K and V
// once: at recurrentgemma-2b's decode (4 rows x 2048 keys x 1 KV head x 256
// x 2 B, K and V) 8.4 MB, 0.0025 ms at 3.35 TB/s, against 84 MFLOP of
// products (0.09 us on the tensor cores, ~1.3 us as f32 FMAs).  The design:
//
// * The key axis is split across blocks (flash-decoding).  One block per
//   (batch row, KV head, split of SPLIT_KV keys): B * KH * ceil(T /
//   SPLIT_KV) blocks, where one block per (row, KV head) made 4 at
//   recurrentgemma-2b's shape on 132 SMs.  Split s holds keys
//   [s * SPLIT_KV, (s + 1) * SPLIT_KV) whatever T; a block whose split
//   starts at or past its row's length writes an empty partial and returns.
// * Inside a block the split's keys stream through the paper's ring: stages
//   of BKV rows of K and V in shared memory, max(buffer_size, distance + 1)
//   of them, filled `distance` stages ahead by cp.async (distance 0: fetch,
//   then wait).  Each row's 16-byte chunks are XOR-swizzled by the row, so
//   ldmatrix reads eight rows without bank conflicts and no row is padded.
// * Both products run on the tensor cores as mma.sync.m16n8k16 (bf16 in,
//   f32 sums).  The G <= 16 query heads are the A tile's 16 rows (zero rows
//   pad it and are never written out), and q stays in registers as A
//   fragments.  Each warp takes 16 keys of a stage: S = Q K^T, the online
//   softmax on S's accumulators (row max and sum by shuffles), then O += P V
//   with P rounded to bf16 from the same registers.  At H = 256 two warps
//   share each 16 keys, so that O (16 x H f32) and q fit a thread's
//   registers without spilling: each holds half of q and of O's columns,
//   computes S over its half of H, and the two add their halves through
//   shared memory (a + b = b + a, so both take the same S and softmax).
//   wgmma takes 64 rows, and G is at most 16.
// * The partials combine in a fixed order: the key groups' states merge in
//   key order into the block's unnormalised f32 O, m and l, written to a
//   workspace that the wrapper allocates; a second kernel, launched by the
//   same entry point, merges each head's splits 0, 1, 2, ... up to its
//   length and divides.  No float atomics.
//
// Every partition (split, stage, key group) follows from key positions alone, so
// a row's bits depend only on its q, its valid prefix and its length: not on
// the PrefetchSpec, on T, or on the batch's other rows.
#include "common.cuh"

namespace {

constexpr int SPLIT_KV = 128;    // keys per block
constexpr int BKV = 64;          // key rows per ring stage
constexpr int KGROUPS = BKV / 16;  // warps along a stage's keys, 16 keys each
constexpr int MAXG = 16;         // query heads per KV head: the A tile's rows
static_assert(SPLIT_KV % BKV == 0, "a split is whole ring stages");

// warps along O's columns, and threads per block
template <int H>
__host__ __device__ constexpr int col_warps() { return H > 128 ? 2 : 1; }
template <int H>
__host__ __device__ constexpr int threads_of() { return 32 * KGROUPS * col_warps<H>(); }

template <int H>
struct Smem {
    static constexpr int STAGE = 2 * BKV * H * 2;  // K then V, bf16, swizzled
    // S's halves exchanged between the two column warps of a key group:
    // [KGROUPS][2][32 lanes][8] f32 (none with one column warp)
    static constexpr int XCHG = col_warps<H>() > 1 ? KGROUPS * 2 * 32 * 8 * 4 : 0;
    // the ring [slots] stages; after the loop its first stage holds the
    // key groups' O [KGROUPS][MAXG][H] f32.  Then m, l and the merge weights
    // [KGROUPS][MAXG] f32, then the exchange.
    static_assert(KGROUPS * MAXG * H * 4 <= STAGE, "the key groups' O fits one stage");
    static size_t bytes(int slots) { return (size_t)slots * STAGE + 3 * KGROUPS * MAXG * 4 + XCHG; }
};

// Element offset of 16-byte chunk c of row r in a [rows][H] bf16 tile whose
// chunks are XOR-swizzled by the row: the eight rows an ldmatrix reads at one
// logical chunk land in eight distinct bank groups.
template <int H>
__device__ __forceinline__ int swz(int r, int c) {
    return r * H + ((c ^ (r & 7)) << 3);
}

// Partial of (b, head n, split s): O at part_o[((b N + n) n_split + s) H],
// (m, l) at part_ml[2 ((b N + n) n_split + s)].
template <int H, int THREADS = threads_of<H>()>
__global__ void __launch_bounds__(THREADS, 1)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int T, int N, int KH,
                    int n_split, int distance, int slots, float sm_scale) {
    constexpr int CPR = H / 8;                // 16-byte chunks per row
    constexpr int CW = col_warps<H>();
    constexpr int HC = H / CW;                // q's and O's columns per warp
    constexpr int KSTEPS = HC / 16;           // k-steps of a warp's share of S = Q K^T
    constexpr int NT = HC / 8;                // n-tiles of a warp's O

    extern __shared__ __align__(128) unsigned char smem[];
    bf16* ring = reinterpret_cast<bf16*>(smem);
    float* Ms = reinterpret_cast<float*>(smem + (size_t)slots * Smem<H>::STAGE);
    float* Ls = Ms + KGROUPS * MAXG;
    float* Ws = Ls + KGROUPS * MAXG;
    float* Xs = Ws + KGROUPS * MAXG;

    const int tid = threadIdx.x, lane = tid % 32;
    const int kg = tid / 32 % KGROUPS, half = tid / 32 / KGROUPS;  // key group, column warp
    const int c0 = half * HC;                                         // its first column
    const int gr = lane / 4, tq = lane % 4;  // fragment rows gr and gr + 8, column pair tq
    const int G = N / KH;
    const int split = blockIdx.x % n_split, bk = blockIdx.x / n_split;
    const int b = bk / KH, kh = bk % KH;
    const int len_b = lengths[b];  // issued before q's loads, which then overlap it

    // this warp's columns of q as A fragments, rows past G zero
    uint32_t qf[KSTEPS][4];
    {
        const bf16* q0 = q + ((size_t)b * N + kh * G) * H + c0 + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = gr + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1);
                qf[kk][e] = row < G ? *reinterpret_cast<const uint32_t*>(q0 + row * H + col) : 0u;
            }
        }
    }
    const int len = max(0, min(len_b, T));
    const int start = split * SPLIT_KV;
    const int stop = min(start + SPLIT_KV, len);
    const size_t part0 = (size_t)(b * N + kh * G) * n_split + split;  // head g: + g * n_split
    // the combine may be scheduled now; it waits for this grid's writes
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    if (start >= len) {  // an empty partial; the combine reads none past the length
        for (int idx = tid; idx < G * H; idx += THREADS)
            part_o[(part0 + (size_t)(idx / H) * n_split) * H + idx % H] = 0.f;
        for (int g = tid; g < G; g += THREADS) {
            part_ml[2 * (part0 + (size_t)g * n_split)] = REPRO_NEG_INF;
            part_ml[2 * (part0 + (size_t)g * n_split) + 1] = 0.f;
        }
        return;
    }
    const int n_stage = (stop - start + BKV - 1) / BKV;

    // stage i -> ring slot i % slots; rows past the length are zero-filled,
    // not read.  Every call commits one group, empty past the last stage, so
    // that stage i is always the group `distance` before the newest one.
    auto issue = [&](int i) {
        if (i < n_stage) {
            bf16* ks = ring + (size_t)(i % slots) * (Smem<H>::STAGE / 2);
            bf16* vs = ks + BKV * H;
            const int t0 = start + i * BKV;
            for (int idx = tid; idx < BKV * CPR; idx += THREADS) {
                const int r = idx / CPR, c = idx % CPR;
                const int t = t0 + r;
                const bool ok = t < stop;
                const size_t off = ((size_t)(b * T + (ok ? t : 0)) * KH + kh) * H + c * 8;
                cp_async_16(ks + swz<H>(r, c), k + off, ok ? 16 : 0);
                cp_async_16(vs + swz<H>(r, c), v + off, ok ? 16 : 0);
            }
        }
        cp_async_commit();
    };

    for (int i = 0; i < distance; ++i) issue(i);  // warm the ring

    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l_run[2] = {0.f, 0.f};  // rows gr, gr + 8
    // ldmatrix rows: lane supplies a row of matrix lane / 8
    const int mat = lane / 8, r8 = lane % 8;
    const int krow = 16 * kg + 8 * (mat >> 1) + r8;  // K: keys 0-7, 0-7, 8-15, 8-15
    const int vrow = 16 * kg + 8 * (mat & 1) + r8;   // V: keys 0-7, 8-15, 0-7, 8-15

    for (int i = 0; i < n_stage; ++i) {
        issue(i + distance);
        cp_async_wait_n(distance);  // stage i has landed
        __syncthreads();
        const int t0 = start + i * BKV + 16 * kg;  // this warp's first key
        if (t0 < stop) {
            const bf16* ks = ring + (size_t)(i % slots) * (Smem<H>::STAGE / 2);
            const bf16* vs = ks + BKV * H;

            // S = Q K^T over this warp's 16 keys: n-tiles keys 0-7 and 8-15
            float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                uint32_t kb[4];
                ldmatrix_x4(kb, ks + swz<H>(krow, c0 / 8 + 2 * kk + (mat & 1)));
                mma_bf16_16816(s[0], qf[kk], kb[0], kb[1]);
                mma_bf16_16816(s[1], qf[kk], kb[2], kb[3]);
            }
            if constexpr (CW > 1) {  // add the other column warp's half of S
                float4* mine = reinterpret_cast<float4*>(Xs + ((kg * 2 + half) * 32 + lane) * 8);
                const float4* other = reinterpret_cast<const float4*>(Xs + ((kg * 2 + 1 - half) * 32 + lane) * 8);
                mine[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
                mine[1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
                asm volatile("bar.sync %0, 64;\n" :: "r"(1 + kg) : "memory");  // this key group's two warps
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float4 x = other[j];
                    s[j][0] += x.x;
                    s[j][1] += x.y;
                    s[j][2] += x.z;
                    s[j][3] += x.w;
                }
            }

            // online softmax; element e of tile j is row gr + 8 (e / 2), key
            // t0 + 8 j + 2 tq + e % 2, and a row's four threads share gr
            float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = t0 + 8 * j + 2 * tq + (e & 1) < stop;
                    s[j][e] = ok ? s[j][e] * sm_scale : REPRO_NEG_INF;
                    mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
                }
            float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                mx[h] = fmaxf(m_run[h], mx[h]);
                alpha[h] = expf(m_run[h] - mx[h]);
                m_run[h] = mx[h];
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = t0 + 8 * j + 2 * tq + (e & 1) < stop;
                    s[j][e] = ok ? expf(s[j][e] - mx[e >> 1]) : 0.f;
                    sum[e >> 1] += s[j][e];
                }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
                sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
                l_run[h] = alpha[h] * l_run[h] + sum[h];
            }

            // O = O alpha + P V, P in bf16 as the A fragment of keys 0-15
            const uint32_t pf[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                                    pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                o[nt][0] *= alpha[0];
                o[nt][1] *= alpha[0];
                o[nt][2] *= alpha[1];
                o[nt][3] *= alpha[1];
            }
#pragma unroll
            for (int n2 = 0; n2 < NT / 2; ++n2) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, vs + swz<H>(vrow, c0 / 8 + 2 * n2 + (mat >> 1)));
                mma_bf16_16816(o[2 * n2], pf, vb[0], vb[1]);
                mma_bf16_16816(o[2 * n2 + 1], pf, vb[2], vb[3]);
            }
        }
        __syncthreads();  // the slot is free for reuse
    }
    cp_async_wait<0>();  // no copy outlives the loop

    // the key groups' states, merged in key order; O's columns swizzled by row
    float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int col = (c0 + 8 * nt + 2 * tq) ^ (gr << 3);
        *reinterpret_cast<float2*>(Os + (kg * MAXG + gr) * H + col) = make_float2(o[nt][0], o[nt][1]);
        *reinterpret_cast<float2*>(Os + (kg * MAXG + gr + 8) * H + col) = make_float2(o[nt][2], o[nt][3]);
    }
    if (tq == 0 && c0 == 0) {
        Ms[kg * MAXG + gr] = m_run[0];
        Ls[kg * MAXG + gr] = l_run[0];
        Ms[kg * MAXG + gr + 8] = m_run[1];
        Ls[kg * MAXG + gr + 8] = l_run[1];
    }
    __syncthreads();
    if (tid < G) {
        float m = REPRO_NEG_INF, l = 0.f;
        for (int w = 0; w < KGROUPS; ++w) m = fmaxf(m, Ms[w * MAXG + tid]);
        for (int w = 0; w < KGROUPS; ++w) {
            Ws[w * MAXG + tid] = expf(Ms[w * MAXG + tid] - m);
            l = fmaf(Ls[w * MAXG + tid], Ws[w * MAXG + tid], l);
        }
        part_ml[2 * (part0 + (size_t)tid * n_split)] = m;
        part_ml[2 * (part0 + (size_t)tid * n_split) + 1] = l;
    }
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < G * H; idx += THREADS) {
        const int g = idx / H, c = idx % H, col = c ^ ((g & 7) << 3);
        float acc = 0.f;
        for (int w = 0; w < KGROUPS; ++w) acc = fmaf(Os[(w * MAXG + g) * H + col], Ws[w * MAXG + g], acc);
        part_o[(part0 + (size_t)g * n_split) * H + c] = acc;
    }
}

// One block per (b, head n), one thread per column: merge the splits that
// hold the row's keys in split order, online (the running max rescales the
// sums, as within a block), and divide by the softmax sum.  Each chunk of
// CHUNK splits is loaded before any is merged, so the loads overlap.
template <int H>
__global__ void __launch_bounds__(H)
decode_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                      const int* __restrict__ lengths, bf16* __restrict__ o, int T, int N,
                      int n_split) {
    constexpr int CHUNK = 16;
    const int bn = blockIdx.x, c = threadIdx.x;
    const int len = max(0, min(lengths[bn / N], T));
    const int n_used = (len + SPLIT_KV - 1) / SPLIT_KV;
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials are written
    const float* ml = part_ml + (size_t)bn * n_split * 2;
    const float* po = part_o + (size_t)bn * n_split * H + c;
    float m = REPRO_NEG_INF, l = 0.f, acc = 0.f;
    for (int s0 = 0; s0 < n_used; s0 += CHUNK) {
        float ms[CHUNK], ls[CHUNK], os[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            const bool ok = s0 + j < n_used;
            ms[j] = ok ? ml[2 * (s0 + j)] : 0.f;
            ls[j] = ok ? ml[2 * (s0 + j) + 1] : 0.f;
            os[j] = ok ? po[(size_t)(s0 + j) * H] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            if (s0 + j < n_used) {
                const float m_new = fmaxf(m, ms[j]);
                const float a = expf(m - m_new), w = expf(ms[j] - m_new);
                l = fmaf(ls[j], w, l * a);
                acc = fmaf(os[j], w, acc * a);
                m = m_new;
            }
        }
    }
    l = (l == 0.f) ? 1.f : l;  // length 0 gives 0
    o[(size_t)bn * H + c] = __float2bfloat16(acc / l);
}

template <int H>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o, void* work,
           int B, int T, int N, int KH, int distance, int slots, float sm_scale,
           cudaStream_t stream) {
    const int n_split = (T + SPLIT_KV - 1) / SPLIT_KV;
    float* part_o = static_cast<float*>(work);
    float* part_ml = part_o + (size_t)B * N * n_split * H;
    if (n_split > 0) {
        const size_t smem = Smem<H>::bytes(slots);
        cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<H>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it, or the next launch's check reports it
            return (int)err;
        }
        decode_split_kernel<H><<<B * KH * n_split, threads_of<H>(), smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const int*>(lengths), part_o, part_ml, T, N, KH, n_split, distance, slots,
            sm_scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    // launched as a programmatic dependent of the split kernel: its blocks
    // start while the split kernel drains and wait for it at
    // griddepcontrol.wait, which hides one launch latency
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * N);
    cfg.blockDim = dim3(H);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<H>, (const float*)part_o,
                                               (const float*)part_ml, static_cast<const int*>(lengths),
                                               static_cast<bf16*>(o), T, N, n_split);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// Keys per block of the split kernel: the wrapper sizes its workspace by it.
extern "C" int repro_decode_attention_split_kv() { return SPLIT_KV; }

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
// o (B, N, H); work f32 of B * N * ceil(T / SPLIT_KV) * (H + 2) elements.
// Launches the split kernel, then the combine.  Returns the first launch
// error's code (cudaGetLastError()).
extern "C" int repro_decode_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* lengths, void* o, void* work, int B,
                                           int T, int N, int KH, int H, int distance, int slots,
                                           float sm_scale, void* stream) {
    if (KH <= 0 || N % KH != 0 || N / KH > MAXG || distance < 0 || slots < distance + 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (H) {
        case 64:
            return launch<64>(q, k, v, lengths, o, work, B, T, N, KH, distance, slots, sm_scale, st);
        case 128:
            return launch<128>(q, k, v, lengths, o, work, B, T, N, KH, distance, slots, sm_scale, st);
        case 256:
            return launch<256>(q, k, v, lengths, o, work, B, T, N, KH, distance, slots, sm_scale, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
