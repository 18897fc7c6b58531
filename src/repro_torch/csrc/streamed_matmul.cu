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
// ride in the same ring stages as w's.  Both routes read x and w in place,
// without padding copies, and sum over k in one fixed order (k ascending)
// whatever the ring: the slot never enters the arithmetic, so every
// PrefetchSpec gives the same bits.
//
// Bound on the H100: at the MLP shapes of smollm-360m (x 2048 x 960,
// w 960 x 2560, bf16) the product needs 10.1 GFLOP and moves 19.3 MB, so
// operations bound it at the tensor-core rate (~10 us).
//
// Two routes, chosen by the wrapper from the dtype and the alignment:
//
// * Tensor cores (bf16 whose K and N are multiples of 8 and whose pointers
//   are 16-byte aligned: TMA needs 16-byte row strides).  128 x 128 output
//   tiles, k-tiles of 64 (128-byte rows under the 128-byte swizzle).  One
//   thread issues the TMA copies of a stage (the x tile, and w's two
//   64-column slabs) into the ring; an mbarrier per slot reports their
//   bytes.  Two warpgroups each issue one m64n128k16 wgmma per 16 of k on
//   their 64 rows, x K-major and w MN-major (the transpose bit: w is read in
//   place, never transposed in memory).  Edges past M, N, K are zero-filled
//   by TMA; only the epilogue masks.  A block barrier ends every k-tile, so
//   a slot is refilled only after both warpgroups' products on it are done.
// * CUDA cores (f32, and bf16 of other strides).  f32 must not round to
//   TF32 (the reference's tolerance is rtol 2e-4), so it runs f32 FMAs, each
//   thread a 4 x 4 block of outputs from float4 / 16-byte shared reads, the
//   tiles staged by cp.async.  The ring holds run-time depth and lookahead:
//   every step commits exactly one cp.async group (empty past the last
//   tile), so tile k is always the group `distance` before the newest and
//   one wait_group(distance) -- a switch over immediates -- covers it.  Rows
//   and columns past M, N, K are zero-filled by cp.async with a short or
//   zero source size.
#include "hopper.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 block of outputs

// x rows in shared memory are padded (16 bytes) so that 16-byte reads of
// neighbouring rows start on different banks.
template <typename T>
struct Stage;
template <>
struct Stage<float> {
    static constexpr int XS = BK + 4;
};
template <>
struct Stage<bf16> {
    static constexpr int XS = BK + 8;
};

// one ring stage: x tile [BM][XS] then w tile [BK][BN]
template <typename T>
__host__ __device__ constexpr size_t x_elems() { return (size_t)BM * Stage<T>::XS; }
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
    return (x_elems<T>() + (size_t)BK * BN) * sizeof(T);
}

template <int CHUNK>
__device__ __forceinline__ void cp_async_chunk(void* smem, const void* gmem, int src_bytes) {
    if constexpr (CHUNK == 16) {
        cp_async_16(smem, gmem, src_bytes);
    } else {
        cp_async_4(smem, gmem, src_bytes);
    }
}

// Copy the k0 tiles of x (rows m0.., cols k0..) and w (rows k0.., cols
// n0..) into one stage; CHUNK bytes per cp.async, and a chunk past the
// matrix edge reads only its valid bytes (or none) and zero-fills the rest.
template <typename T, int CHUNK>
__device__ __forceinline__ void load_stage(T* xs, T* ws, const T* __restrict__ x,
                                           const T* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
    constexpr int E = CHUNK / (int)sizeof(T);  // elements per copy
    constexpr int XS = Stage<T>::XS;
    constexpr int XC = BK / E;
    for (int idx = tid; idx < BM * XC; idx += THREADS) {
        const int r = idx / XC, c = (idx % XC) * E;
        const int m = m0 + r, k = k0 + c;
        const int bytes = (m < M && k < K) ? min(E, K - k) * (int)sizeof(T) : 0;
        cp_async_chunk<CHUNK>(xs + r * XS + c, bytes ? x + (size_t)m * K + k : x, bytes);
    }
    constexpr int WC = BN / E;
    for (int idx = tid; idx < BK * WC; idx += THREADS) {
        const int r = idx / WC, c = (idx % WC) * E;
        const int k = k0 + r, n = n0 + c;
        const int bytes = (k < K && n < N) ? min(E, N - n) * (int)sizeof(T) : 0;
        cp_async_chunk<CHUNK>(ws + r * BN + c, bytes ? w + (size_t)k * N + n : w, bytes);
    }
}

// acc[i][c] += sum over the stage's k of x[row i][k] * w[k][col c], k ascending
__device__ __forceinline__ void compute_stage(const float* xs, const float* ws,
                                              float (&acc)[4][4], int ty, int tx) {
    constexpr int XS = Stage<float>::XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(xs + (ty * 4 + i) * XS + kk);
            a[i][0] = v.x;
            a[i][1] = v.y;
            a[i][2] = v.z;
            a[i][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 b = *reinterpret_cast<const float4*>(ws + (kk + j) * BN + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(a[i][j], b.x, acc[i][0]);
                acc[i][1] = fmaf(a[i][j], b.y, acc[i][1]);
                acc[i][2] = fmaf(a[i][j], b.z, acc[i][2]);
                acc[i][3] = fmaf(a[i][j], b.w, acc[i][3]);
            }
        }
    }
}

__device__ __forceinline__ void compute_stage(const bf16* xs, const bf16* ws,
                                              float (&acc)[4][4], int ty, int tx) {
    constexpr int XS = Stage<bf16>::XS;
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int CHUNK>
__global__ void __launch_bounds__(THREADS)
streamed_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int M, int N, int K, int distance, int slots) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int n_k = (K + BK - 1) / BK;

    auto xs_of = [&](int slot) {
        return reinterpret_cast<T*>(smem + (size_t)slot * stage_bytes<T>());
    };
    // tile t -> ring slot t % slots; one committed group per call, empty
    // past the last tile, so tile k is always `distance` groups behind
    auto issue = [&](int t) {
        if (t < n_k) {
            T* xs = xs_of(t % slots);
            load_stage<T, CHUNK>(xs, xs + x_elems<T>(), x, w, M, N, K, m0, n0, t * BK, tid);
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
        const T* xs = xs_of(k % slots);
        compute_stage(xs, xs + x_elems<T>(), acc, ty, tx);
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
            if (n < N) store(y + (size_t)m * N + n, acc[i][c]);
        }
    }
}

template <typename T, int CHUNK>
int launch(const void* x, const void* w, void* y, int M, int N, int K, int distance, int slots,
           cudaStream_t stream) {
    const size_t smem = (size_t)slots * stage_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(streamed_matmul_kernel<T, CHUNK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
    streamed_matmul_kernel<T, CHUNK><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), M, N, K,
        distance, slots);
    return (int)cudaGetLastError();
}

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

// Bytes of one ring stage for dtype 0 (f32, the CUDA-core tile) or 1 (bf16,
// the tensor-core tile): the stage that bounds each dtype's ring; the
// wrapper holds its own copy of the tile constants and checks them against
// this.
extern "C" int repro_streamed_matmul_stage_bytes(int dtype) {
    return dtype == 0 ? (int)stage_bytes<float>() : (int)tc::STAGE;
}

// Shared memory of the tensor-core route's ring of `slots` stages, the
// 1024-byte alignment pad and the mbarriers included.
extern "C" int repro_streamed_matmul_tc_smem_bytes(int slots) {
    return (int)tc::smem_bytes(slots);
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

// x (M, K), w (K, N), y (M, N), contiguous, dtype 0 = f32, 1 = bf16; chunk
// is the cp.async width in bytes (16 needs 16-byte rows and pointers, 4
// needs 4-byte ones).  Returns the launch's cudaGetLastError() code.
extern "C" int repro_streamed_matmul(const void* x, const void* w, void* y, int M, int N, int K,
                                     int dtype, int chunk, int distance, int slots,
                                     void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || distance < 0 || slots < distance + 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && chunk == 16) return launch<float, 16>(x, w, y, M, N, K, distance, slots, st);
    if (dtype == 0 && chunk == 4) return launch<float, 4>(x, w, y, M, N, K, distance, slots, st);
    if (dtype == 1 && chunk == 16) return launch<bf16, 16>(x, w, y, M, N, K, distance, slots, st);
    if (dtype == 1 && chunk == 4) return launch<bf16, 4>(x, w, y, M, N, K, distance, slots, st);
    return (int)cudaErrorInvalidValue;
}
