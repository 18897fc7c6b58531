// Streamed matmul: y = x @ w, f32 accumulation, y in x's dtype (f32 or bf16).
//
// Replaces the TPU kernel _streamed_matmul_kernel / streamed_matmul_p in
// src/repro/kernels/streamed_matmul/kernel.py.  What it computes is the
// same: the weights stay in device memory, passed by reference, and tiles
// of w stream through a shared-memory ring of `slots` stages, the copy of
// tile k + distance issued before tile k is computed (distance 0: issue
// tile k, wait, compute -- the paper's on-demand mode).  The TPU kernel
// keeps a whole (bm, K) row block of x in VMEM; a block of x at K = 2560 in
// bf16 does not fit an SM's 227 KB of shared memory, so here the tiles of x
// ride in the same ring stages as w's.  Every route reads x and w in place,
// without padding copies, and sums over k in an order fixed by the shapes
// alone: the slot never enters the arithmetic, so every PrefetchSpec gives
// the same bits.
//
// Three routes, chosen by the wrapper from the dtype and the alignment:
//
// * f32 (CUDA cores).  f32 must not round to TF32 (the reference's
//   tolerance is rtol 2e-4), so it runs plain f32 FMAs.  Bound on the H100:
//   operations; at the JAX sweep's 512^3, 268 MFLOP at 67 TFLOP/s is 4.0 us,
//   but one block per output tile would leave half of the 132 SMs idle
//   there.  The design (namespace f32):
//   - K is split across blocks by a plan that depends on (M, N, K) alone
//     (ops.split_plan, passed in and checked to take every k-tile once):
//     S runs of whole k-tiles, enough that tiles x S fills the card twice.
//     Split s writes its partial to an f32 workspace; a second kernel,
//     launched as a programmatic dependent, adds the S partials into y in
//     split order.  No float atomics.  S = 1 writes y directly.  (Adding
//     them in the block of each tile that takes the tile's last ticket
//     was slower on the card: 64 blocks then read every partial while the
//     others sit idle.)
//   - 64 x 64 output tiles over k-tiles of 32, 8 x 4 outputs per thread in
//     registers (128 threads): every 4 of k a thread makes 12 16-byte
//     shared reads for 128 FMAs, summing its k in ascending order.  A
//     thread's rows are strided by 8, so a warp reads 2 neighbouring rows at
//     once, and x's 128-byte rows are XOR-swizzled (TMA's 128-byte swizzle)
//     so that any 8 neighbouring rows fall on distinct banks.  (The tile
//     sweep, matmul_tile_sweep.py, timed 128 x 64 tiles and 8 x 8 outputs
//     too: no faster on the card, with twice the splits to combine.)
//   - The ring has a full and an empty mbarrier per slot: a slot is
//     refilled once every warp has released it, not at a block barrier.
//     Where K and N are multiples of 4 and both pointers 16-byte aligned,
//     one thread fills a stage with two TMA copies (the tensor maps of the
//     last few operands are kept: encoding them is host time); other
//     strides take 4-byte cp.async copies, zero-filled past the edges,
//     issued by every thread and reported by cp.async.mbarrier.arrive.  A
//     stage is 16 KB, so a ring of 14 fits.
// * bf16 tensor cores (bf16 whose K and N are multiples of 8 and whose
//   pointers are 16-byte aligned: TMA needs 16-byte row strides).  128 x 128
//   output tiles, k-tiles of 64 (128-byte rows under the 128-byte swizzle).
//   One thread issues the TMA copies of a stage (the x tile, and w's two
//   64-column slabs) into the ring; an mbarrier per slot reports their
//   bytes.  Two warpgroups each issue one m64n128k16 wgmma per 16 of k on
//   their 64 rows, x K-major and w MN-major (the transpose bit: w is read in
//   place, never transposed in memory).  Edges past M, N, K are zero-filled
//   by TMA; only the epilogue masks.  A block barrier ends every k-tile, so
//   a slot is refilled only after both warpgroups' products on it are done.
//   At smollm-360m's MLP shapes (x 2048 x 960, w 960 x 2560) the product
//   needs 10.1 GFLOP and moves 19.3 MB: operations bound it (~10 us).
// * bf16 CUDA cores (bf16 of other strides; namespace cc).  Each thread a
//   4 x 4 block of outputs from 16-byte shared reads, the tiles staged by
//   4-byte cp.async.  Every step commits exactly one cp.async group (empty past
//   the last tile), so tile k is always the group `distance` before the
//   newest and one wait_group(distance) -- a switch over immediates --
//   covers it.  Rows and columns past M, N, K are zero-filled by cp.async
//   with a short or zero source size.
#include <mutex>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// the f32 route (CUDA cores)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 64, BN = 64, BK = 32;  // output tile, k-tile
constexpr int TM = 8, TN = 4;              // outputs per thread: rows, columns
constexpr int TX = BN / TN, TY = BM / TM;  // threads along the columns, the rows
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_BYTES = BK * 4;                  // an x row of a stage: the swizzle's span
constexpr uint32_t X_BYTES = BM * BK * 4;          // x tile [BM][BK], rows swizzled
constexpr uint32_t STAGE = X_BYTES + BK * BN * 4;  // then w tile [BK][BN]
constexpr uint32_t ALIGN = 1024;                   // stages start on the swizzle's repeat
constexpr int COMBINE_THREADS = 256;
static_assert(ROW_BYTES == 64 || ROW_BYTES == 128, "x rows span TMA's 64- or 128-byte swizzle");
static_assert(TN % 4 == 0 && 32 % TX == 0 && THREADS % 32 == 0, "threads tile the output");
static_assert(STAGE % ALIGN == 0, "every stage starts on the swizzle's repeat");

// the ring's shared memory: the base pad, the stages, a full and an empty
// mbarrier per slot
__host__ __device__ constexpr size_t smem_bytes(int slots) {
    return ALIGN + (size_t)slots * STAGE + (size_t)slots * 2 * sizeof(uint64_t);
}

// The x tile's rows of BK floats hold their 16-byte chunks where TMA's
// swizzle of ROW_BYTES puts them: chunk XOR bits 7.. of the row's offset.
// The cp.async route writes the same layout.
__host__ __device__ constexpr int x_swizzle(int r) { return ((r * ROW_BYTES) >> 7) & (ROW_BYTES / 16 - 1); }
__device__ __forceinline__ int x_off(int r, int k) { return r * BK + (((k >> 2) ^ x_swizzle(r)) << 2) + (k & 3); }
// a thread's rows r, r + TY, ... share one swizzle, so it is computed once
static_assert((TY * ROW_BYTES / 128) % (ROW_BYTES / 16) == 0, "rows TY apart share a swizzle");

// The cp.async route's copies of one stage: 4 bytes each, those past M, N,
// K reading nothing and writing zeros.
__device__ __forceinline__ void load_stage(float* xs, float* ws, const float* __restrict__ x,
                                           const float* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK, m = m0 + r, k = k0 + c;
        const bool ok = m < M && k < K;
        cp_async_4(xs + x_off(r, c), ok ? x + (size_t)m * K + k : x, ok ? 4 : 0);
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
        const int r = idx / BN, c = idx % BN, k = k0 + r, n = n0 + c;
        const bool ok = k < K && n < N;
        cp_async_4(ws + r * BN + c, ok ? w + (size_t)k * N + n : w, ok ? 4 : 0);
    }
}

// acc[i][c] += x[row ty + TY i][k] * w[k][column c of the thread], over the
// stage's k in ascending order.  The thread's columns: TN / 4 groups of 4
// at tx * 4 + 4 TX g, so a warp's TX threads read 4 TX neighbouring floats.
__device__ __forceinline__ void compute_stage(const float* xs, const float* ws,
                                              float (&acc)[TM][TN], int ty, int tx) {
    const float* xr = xs + ty * BK;  // row ty; row ty + TY i is TY BK i floats on
    const float* wc = ws + tx * 4;
    const int sw = x_swizzle(ty);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
        const float* xk = xr + (((kk >> 2) ^ sw) << 2);
        float a[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(xk + TY * BK * i);
            a[i][0] = v.x;
            a[i][1] = v.y;
            a[i][2] = v.z;
            a[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float b[TN];
#pragma unroll
            for (int g = 0; g < TN / 4; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(wc + (kk + q) * BN + g * 4 * TX);
                b[4 * g] = v.x;
                b[4 * g + 1] = v.y;
                b[4 * g + 2] = v.z;
                b[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i][q], b[c], acc[i][c]);
        }
    }
}

// One block per (M tile, N tile, split): the split's run of k-tiles through
// the ring, then its partial (or y, with one split) written out.
template <bool TMA>
__global__ void __launch_bounds__(THREADS)
streamed_matmul_f32_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                           const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ out, int M, int N, int K, int kps, int distance,
                           int slots) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)slots * STAGE);
    uint64_t* empty = full + slots;
    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int n_kt = (K + BK - 1) / BK, kt0 = blockIdx.z * kps;
    const int n = max(0, min(kps, n_kt - kt0));  // the split's k-tiles: kt0, kt0 + 1, ...
    float* dst = out + (size_t)blockIdx.z * M * N;

    // the combine may be scheduled now; it waits for this grid's writes
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    if (tid == 0) {
        for (int s = 0; s < slots; ++s) {
            hopper::mbar_init(&full[s], TMA ? 1 : THREADS);
            hopper::mbar_init(&empty[s], WARPS);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    auto stage = [&](int slot) { return reinterpret_cast<float*>(smem + (size_t)slot * STAGE); };
    // the split's tile j -> slot j % slots; its use u = j / slots refills the
    // slot once every warp has released use u - 1 (the empty phase u - 1)
    auto issue = [&](int j) {
        if (j >= n) return;
        const int slot = j % slots, use = j / slots, k0 = (kt0 + j) * BK;
        float* xs = stage(slot);
        if constexpr (TMA) {
            if (tid == 0) {
                if (use) hopper::mbar_wait(&empty[slot], (use - 1) & 1);
                hopper::mbar_arrive_expect_tx(&full[slot], STAGE);
                hopper::tma_load_2d(xs, &mx, &full[slot], k0, m0);
                hopper::tma_load_2d(xs + BM * BK, &mw, &full[slot], n0, k0);
            }
        } else {
            if (use) hopper::mbar_wait(&empty[slot], (use - 1) & 1);
            load_stage(xs, xs + BM * BK, x, w, M, N, K, m0, n0, k0, tid);
            hopper::cp_async_mbar_arrive(&full[slot]);
        }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

    for (int j = 0; j < distance; ++j) issue(j);  // warm the ring
    for (int j = 0; j < n; ++j) {
        issue(j + distance);
        const int slot = j % slots;
        hopper::mbar_wait(&full[slot], (j / slots) & 1);
        const float* xs = stage(slot);
        compute_stage(xs, xs + BM * BK, acc, ty, tx);
        __syncwarp();
        if (tid % 32 == 0) hopper::mbar_arrive(&empty[slot]);  // the warp is done with the slot
    }

    const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + TY * i;
        if (m >= M) continue;
        float* row = dst + (size_t)m * N;
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
            const int c = n0 + tx * 4 + g * 4 * TX;
            const float* v = &acc[i][4 * g];
            if (vec && c < N) {
                *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (c + e < N) row[c + e] = v[e];
            }
        }
    }
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// y = p_0 + p_1 + ... + p_{S-1}, added in split order; V = float4 where M N
// is a multiple of 4 and y is 16-byte aligned, else float.  `count` is the
// number of V in one partial.
template <typename V>
__global__ void __launch_bounds__(COMBINE_THREADS)
streamed_matmul_f32_combine_kernel(const V* __restrict__ part, V* __restrict__ y, long long count,
                                   int splits) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // every split's partial is written
    const long long i = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
    if (i >= count) return;
    V acc = part[i];
#pragma unroll 4
    for (int s = 1; s < splits; ++s) acc = add(acc, part[s * count + i]);
    y[i] = acc;
}

template <typename V>
int launch_combine(const float* part, float* y, long long mn, int splits, cudaStream_t stream) {
    const long long count = mn / (long long)(sizeof(V) / sizeof(float));
    // a programmatic dependent of the split kernel: its blocks start while
    // that kernel drains and wait for it at griddepcontrol.wait
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((count + COMBINE_THREADS - 1) / COMBINE_THREADS));
    cfg.blockDim = dim3(COMBINE_THREADS);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, streamed_matmul_f32_combine_kernel<V>,
                                               reinterpret_cast<const V*>(part), reinterpret_cast<V*>(y),
                                               count, splits);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Raises the split kernel's dynamic shared-memory limit on the current
// device to `bytes` the first time a ring needs that much: the attribute
// call costs the host more than the launch does.
template <bool TMA>
cudaError_t allow_smem(size_t bytes) {
    constexpr int DEVICES = 64;
    static std::mutex mu;
    static size_t allowed[DEVICES] = {};  // the limit set so far on each device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev >= DEVICES) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (allowed[dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(streamed_matmul_f32_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return err;
    }
    allowed[dev] = bytes;
    return cudaSuccess;
}

// The tensor map of x (is_x: `outer` = M rows of `inner` = K floats, boxes
// of BM x BK under the x tile's swizzle) or of w (K rows of N, boxes of BK x
// BN).  Encoding one costs the host about as much as a launch, and a map is
// a function of the operand's address and shape alone, so the maps of the
// last few operands are kept and reused.
int operand_map(CUtensorMap* map, const float* ptr, uint64_t inner, uint64_t outer, bool is_x) {
    struct Kept {
        const float* ptr;
        uint64_t inner, outer;
        CUtensorMap map;
    };
    constexpr int KEPT = 8;
    static std::mutex mu;
    static Kept kept[2][KEPT] = {};  // [is_x]: a ring of the last KEPT maps
    static int next[2] = {};
    std::lock_guard<std::mutex> lock(mu);
    for (const Kept& e : kept[is_x]) {
        if (e.ptr == ptr && e.inner == inner && e.outer == outer) {
            *map = e.map;
            return 0;
        }
    }
    const uint64_t dims[2] = {inner, outer}, strides[1] = {inner * 4};
    const uint32_t box[2] = {is_x ? (uint32_t)BK : (uint32_t)BN, is_x ? (uint32_t)BM : (uint32_t)BK};
    const CUtensorMapSwizzle swizzle = !is_x           ? CU_TENSOR_MAP_SWIZZLE_NONE
                                       : ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_128B;
    const int rc =
        hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 2, dims, strides, box, swizzle);
    if (rc) return rc;
    kept[is_x][next[is_x]] = {ptr, inner, outer, *map};
    next[is_x] = (next[is_x] + 1) % KEPT;
    return 0;
}

int launch(const float* x, const float* w, float* y, float* work, int M, int N, int K, int splits, int kps,
           bool tma, int distance, int slots, cudaStream_t stream) {
    CUtensorMap mx = {}, mw = {};  // read only by the TMA route
    if (tma) {
        int rc = operand_map(&mx, x, (uint64_t)K, (uint64_t)M, true);
        if (rc == 0) rc = operand_map(&mw, w, (uint64_t)N, (uint64_t)K, false);
        if (rc) return rc;
    }
    auto kernel = tma ? streamed_matmul_f32_kernel<true> : streamed_matmul_f32_kernel<false>;
    const size_t smem = smem_bytes(slots);
    cudaError_t err = tma ? allow_smem<true>(smem) : allow_smem<false>(smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
    kernel<<<grid, THREADS, smem, stream>>>(mx, mw, x, w, splits > 1 ? work : y, M, N, K, kps, distance,
                                            slots);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const long long mn = (long long)M * N;
    if (mn % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0)
        return launch_combine<float4>(work, y, mn, splits, stream);
    return launch_combine<float>(work, y, mn, splits, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// the CUDA-core route of bf16 of other strides
// ---------------------------------------------------------------------------

namespace cc {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 block of outputs
// x rows in shared memory are padded (16 bytes) so that 16-byte reads of
// neighbouring rows start on different banks
constexpr int XS = BK + 8;

// one ring stage: x tile [BM][XS] then w tile [BK][BN]
constexpr size_t X_ELEMS = (size_t)BM * XS;
constexpr size_t STAGE = (X_ELEMS + (size_t)BK * BN) * sizeof(bf16);

// Copy the k0 tiles of x (rows m0.., cols k0..) and w (rows k0.., cols
// n0..) into one stage; 4 bytes (2 elements) per cp.async, and a chunk past
// the matrix edge reads only its valid bytes (or none) and zero-fills the rest.
__device__ __forceinline__ void load_stage(bf16* xs, bf16* ws, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
    constexpr int E = 2;  // elements per copy
    constexpr int XC = BK / E;
    for (int idx = tid; idx < BM * XC; idx += THREADS) {
        const int r = idx / XC, c = (idx % XC) * E;
        const int m = m0 + r, k = k0 + c;
        const int bytes = (m < M && k < K) ? min(E, K - k) * (int)sizeof(bf16) : 0;
        cp_async_4(xs + r * XS + c, bytes ? x + (size_t)m * K + k : x, bytes);
    }
    constexpr int WC = BN / E;
    for (int idx = tid; idx < BK * WC; idx += THREADS) {
        const int r = idx / WC, c = (idx % WC) * E;
        const int k = k0 + r, n = n0 + c;
        const int bytes = (k < K && n < N) ? min(E, N - n) * (int)sizeof(bf16) : 0;
        cp_async_4(ws + r * BN + c, bytes ? w + (size_t)k * N + n : w, bytes);
    }
}

// acc[i][c] += sum over the stage's k of x[row i][k] * w[k][col c], k ascending
__device__ __forceinline__ void compute_stage(const bf16* xs, const bf16* ws, float (&acc)[4][4],
                                              int ty, int tx) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
        float a[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) unpack_bf16x8(xs + (ty * 4 + i) * XS + kk, a[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint2 raw = *reinterpret_cast<const uint2*>(ws + (kk + j) * BN + tx * 4);
            const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
            const float2 b01 = __bfloat1622float2(h2[0]);
            const float2 b23 = __bfloat1622float2(h2[1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(a[i][j], b01.x, acc[i][0]);
                acc[i][1] = fmaf(a[i][j], b01.y, acc[i][1]);
                acc[i][2] = fmaf(a[i][j], b23.x, acc[i][2]);
                acc[i][3] = fmaf(a[i][j], b23.y, acc[i][3]);
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
streamed_matmul_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
                            int M, int N, int K, int distance, int slots) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int n_k = (K + BK - 1) / BK;

    auto xs_of = [&](int slot) { return reinterpret_cast<bf16*>(smem + (size_t)slot * STAGE); };
    // tile t -> ring slot t % slots; one committed group per call, empty
    // past the last tile, so tile k is always `distance` groups behind
    auto issue = [&](int t) {
        if (t < n_k) {
            bf16* xs = xs_of(t % slots);
            load_stage(xs, xs + X_ELEMS, x, w, M, N, K, m0, n0, t * BK, tid);
        }
        cp_async_commit();
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int t = 0; t < distance; ++t) issue(t);  // warm the ring
    for (int k = 0; k < n_k; ++k) {
        issue(k + distance);
        cp_async_wait_n(distance);  // this thread's copies of tile k have landed
        __syncthreads();            // ... and every thread's
        const bf16* xs = xs_of(k % slots);
        compute_stage(xs, xs + X_ELEMS, acc, ty, tx);
        __syncthreads();  // the slot is free for reuse
    }
    cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int n = n0 + tx * 4 + c;
            if (n < N) y[(size_t)m * N + n] = __float2bfloat16(acc[i][c]);
        }
    }
}

int launch(const void* x, const void* w, void* y, int M, int N, int K, int distance, int slots,
           cudaStream_t stream) {
    const size_t smem = (size_t)slots * STAGE;
    cudaError_t err = cudaFuncSetAttribute(streamed_matmul_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    streamed_matmul_bf16_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), M, N, K,
        distance, slots);
    return (int)cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// the tensor-core route (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int THREADS = 256;                      // two warpgroups of 64 rows each
constexpr uint32_t A_BYTES = BM * BK * 2;         // x tile: 128 rows of 128 bytes
constexpr uint32_t B_SLAB = BK * 64 * 2;          // w: 64 k-rows x 64 columns
constexpr uint32_t STAGE = A_BYTES + 2 * B_SLAB;  // 32,768
constexpr uint32_t ALIGN = 1024;                  // the swizzle atom

// the ring's shared memory: the base pad, the stages, one mbarrier per slot
__host__ __device__ constexpr size_t smem_bytes(int slots) {
    return ALIGN + (size_t)slots * STAGE + (size_t)slots * sizeof(uint64_t);
}

__global__ void __launch_bounds__(THREADS, 1)
streamed_matmul_tc_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                          bf16* __restrict__ y, int M, int N, int K, int distance, int slots) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)slots * STAGE);
    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int n_kt = (K + BK - 1) / BK;

    if (tid == 0) {
        for (int s = 0; s < slots; ++s) hopper::mbar_init(&full[s], 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    // k-tile t -> slot t % slots: the x tile, then w's two 64-column slabs
    auto issue = [&](int t) {
        if (tid == 0 && t < n_kt) {
            unsigned char* st = smem + (size_t)(t % slots) * STAGE;
            uint64_t* bar = &full[t % slots];
            hopper::mbar_arrive_expect_tx(bar, STAGE);
            hopper::tma_load_2d(st, &mx, bar, t * BK, m0);
            hopper::tma_load_2d(st + A_BYTES, &mw, bar, n0, t * BK);
            hopper::tma_load_2d(st + A_BYTES + B_SLAB, &mw, bar, n0 + 64, t * BK);
        }
    };

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int t = 0; t < distance; ++t) issue(t);  // warm the ring
    for (int kt = 0; kt < n_kt; ++kt) {
        issue(kt + distance);
        const int slot = kt % slots;
        hopper::mbar_wait(&full[slot], (kt / slots) & 1);
        const unsigned char* a = smem + (size_t)slot * STAGE + wg * 64 * 128;
        const unsigned char* b = smem + (size_t)slot * STAGE + A_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            hopper::wgmma_m64n128k16_ss<1>(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                                           hopper::desc_sw128(b + kk * 2048, B_SLAB, 1024), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        __syncthreads();  // both warpgroups are done with the slot: it may be refilled
    }

    // d[4j + e]: row 16 * warp + lane / 4 + 8 * (e / 2), column 8 j + 2 (lane % 4) + e % 2;
    // N is a multiple of 8, so a pair of columns is in range or out together
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row < M && col < N)
                *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
}

int launch(const void* x, const void* w, void* y, int M, int N, int K, int distance, int slots,
           cudaStream_t stream) {
    CUtensorMap mx, mw;
    const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M}, x_strides[1] = {(uint64_t)K * 2};
    const uint32_t x_box[2] = {BK, BM};
    int rc = hopper::encode_bf16_map(&mx, x, 2, x_dims, x_strides, x_box);
    if (rc) return rc;
    const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)K}, w_strides[1] = {(uint64_t)N * 2};
    const uint32_t w_box[2] = {64, BK};
    rc = hopper::encode_bf16_map(&mw, w, 2, w_dims, w_strides, w_box);
    if (rc) return rc;
    const size_t smem = smem_bytes(slots);
    cudaError_t err = cudaFuncSetAttribute(streamed_matmul_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    streamed_matmul_tc_kernel<<<grid, THREADS, smem, stream>>>(mx, mw, static_cast<bf16*>(y), M, N, K,
                                                               distance, slots);
    return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Bytes of one ring stage for dtype 0 (f32) or 1 (bf16, the tensor-core
// tile): the stage that bounds each dtype's ring; the wrapper holds its own
// copy of the tile constants and checks them against this.
extern "C" int repro_streamed_matmul_stage_bytes(int dtype) {
    return dtype == 0 ? (int)f32::STAGE : (int)tc::STAGE;
}

// Shared memory of the f32 route's ring of `slots` stages, the 1024-byte
// alignment pad and the two mbarriers per slot included.
extern "C" int repro_streamed_matmul_f32_smem_bytes(int slots) { return (int)f32::smem_bytes(slots); }

// Shared memory of the tensor-core route's ring of `slots` stages, the
// 1024-byte alignment pad and the mbarriers included.
extern "C" int repro_streamed_matmul_tc_smem_bytes(int slots) {
    return (int)tc::smem_bytes(slots);
}

// The f32 route: x (M, K), w (K, N), y (M, N), contiguous f32, K split into
// `splits` runs of `kps` k-tiles (the last may be shorter; ops.split_plan);
// `work` f32 of splits * M * N elements when splits > 1 (else unread).
// tma = 1 needs K and N multiples of 4 and 16-byte aligned x and w.
// Launches the split kernel and, with more than one split, the combine.
// Returns the first launch error's code (cudaGetLastError()), the tensor
// maps' encoding error, or cudaErrorInvalidValue for a plan that does not
// take every k-tile once.
extern "C" int repro_streamed_matmul_f32(const void* x, const void* w, void* y, void* work, int M, int N,
                                         int K, int splits, int kps, int tma, int distance, int slots,
                                         void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || distance < 0 || slots < distance + 1 ||
        (N + f32::BN - 1) / f32::BN > 65535)
        return (int)cudaErrorInvalidValue;
    // every split holds at least one k-tile (K = 0: one split), and together they hold all
    const long long n_kt = (K + f32::BK - 1) / f32::BK;
    const bool once = n_kt == 0 ? splits == 1
                                : splits >= 1 && kps >= 1 && (long long)(splits - 1) * kps < n_kt &&
                                      (long long)splits * kps >= n_kt;
    if (!once || splits > 65535 || (splits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
    if (tma && (K == 0 || K % 4 || N % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
                reinterpret_cast<uintptr_t>(w) % 16))
        return (int)cudaErrorInvalidValue;
    return f32::launch(static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
                       static_cast<float*>(work), M, N, K, splits, kps, tma != 0, distance, slots,
                       static_cast<cudaStream_t>(stream));
}

// The tensor-core route: bf16 x (M, K), w (K, N), y (M, N), contiguous, K
// and N multiples of 8, x and w 16-byte aligned.  Returns the launch's
// cudaGetLastError() code (or the tensor map's encoding error).
extern "C" int repro_streamed_matmul_tc(const void* x, const void* w, void* y, int M, int N, int K,
                                        int distance, int slots, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || distance < 0 || slots < distance + 1)
        return (int)cudaErrorInvalidValue;
    return tc::launch(x, w, y, M, N, K, distance, slots, static_cast<cudaStream_t>(stream));
}

// The CUDA-core route of bf16: x (M, K), w (K, N), y (M, N), contiguous,
// K and N even, x and w 4-byte aligned (4-byte cp.async copies).  Returns
// the launch's cudaGetLastError() code.
extern "C" int repro_streamed_matmul_bf16(const void* x, const void* w, void* y, int M, int N, int K,
                                          int distance, int slots, void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || K % 2 || N % 2 || reinterpret_cast<uintptr_t>(x) % 4 ||
        reinterpret_cast<uintptr_t>(w) % 4 || distance < 0 || slots < distance + 1)
        return (int)cudaErrorInvalidValue;
    return cc::launch(x, w, y, M, N, K, distance, slots, static_cast<cudaStream_t>(stream));
}
