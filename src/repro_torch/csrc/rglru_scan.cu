// The RG-LRU's linear recurrence h_t = a_t * h_{t-1} + b_t over time,
// h_0 = 0, f32 in and out.
//
// Replaces the TPU kernel _lru_kernel / linear_recurrence_p in
// src/repro/kernels/rglru_scan/kernel.py.  What it computes is the same:
// the recurrence is sequential in t and independent across the (B, W)
// channels, the gate tensors stay in device memory, only a (chunk_t,
// block_w) tile of a and b is on chip at a time, and the state h is carried
// from one time chunk to the next (on the TPU in VMEM scratch across grid
// steps; here in a register of the thread that owns the channel).
//
// Bound on the H100: the function must read a and b once and write h once,
// 12 bytes per element, against 2 floating-point operations, so bytes bound
// it: 3 x 125,829,120 B at (4, 3072, 2560), ~0.113 ms at 3.35 TB/s.  The
// design: one block per (batch row, block of block_w channels), one thread
// per channel walking time.  Time chunks of a and b stream through a
// double-buffered cp.async ring in shared memory (the counterpart of
// Mosaic's implicit chunk pipeline): chunk i + 1 is in flight while chunk i
// is consumed.  Loads and stores are coalesced across channels.  Edges are
// handled in place: rows past S are zero-filled and never stored, channels
// past W are neither read nor stored.  Each channel's operations run in
// one order, a product then a sum, each rounded, whatever the tiling, so
// the value is bitwise invariant to chunk_t and block_w.
//
// At the serving shape only B * W / block_w = 40 blocks run on 132 SMs:
// a scan parallel over time chunks (a second pass carrying the chunks'
// states) is the redesign that fills the card.
#include "common.cuh"

namespace {

// Each thread owns one channel; the ring holds 2 stages of a and b tiles,
// each (rows, block_w) f32 row-major in shared memory.
template <bool VEC>
__global__ void rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float* __restrict__ h, int S, int W, int rows) {
    extern __shared__ __align__(16) float smem[];
    const int bw = blockDim.x;
    const int tid = threadIdx.x;
    const int w0 = blockIdx.x * bw;
    const int c = w0 + tid;
    const size_t base = (size_t)blockIdx.y * S * W;
    const int n_chunks = (S + rows - 1) / rows;
    const size_t tile = (size_t)rows * bw;

    // chunk i -> stage i % 2; one committed group per call, empty past the end
    auto issue = [&](int i) {
        if (i < n_chunks) {
            float* As = smem + (size_t)(i & 1) * 2 * tile;
            float* Bs = As + tile;
            const int t0 = i * rows;
            if (VEC) {  // 16-byte copies: W % 4 == 0 and 16-byte aligned pointers
                const int cpr = bw / 4;
                for (int idx = tid; idx < rows * cpr; idx += bw) {
                    const int r = idx / cpr, cc = (idx % cpr) * 4;
                    const bool ok = t0 + r < S && w0 + cc < W;
                    const size_t off = ok ? base + (size_t)(t0 + r) * W + w0 + cc : 0;
                    cp_async_16(As + r * bw + cc, a + off, ok ? 16 : 0);
                    cp_async_16(Bs + r * bw + cc, b + off, ok ? 16 : 0);
                }
            } else {
                for (int idx = tid; idx < rows * bw; idx += bw) {
                    const int r = idx / bw, cc = idx % bw;
                    const bool ok = t0 + r < S && w0 + cc < W;
                    const size_t off = ok ? base + (size_t)(t0 + r) * W + w0 + cc : 0;
                    cp_async_4(As + r * bw + cc, a + off, ok ? 4 : 0);
                    cp_async_4(Bs + r * bw + cc, b + off, ok ? 4 : 0);
                }
            }
        }
        cp_async_commit();
    };

    issue(0);
    float hv = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
        issue(i + 1);
        cp_async_wait<1>();  // chunk i has landed (this thread's copies)
        __syncthreads();     // ... and every thread's
        const float* As = smem + (size_t)(i & 1) * 2 * tile;
        const float* Bs = As + tile;
        const int t0 = i * rows;
        const int n = min(rows, S - t0);
        if (c < W) {
            float* out = h + base + (size_t)t0 * W + c;
#pragma unroll 8
            for (int r = 0; r < n; ++r) {
                hv = __fadd_rn(__fmul_rn(As[r * bw + tid], hv), Bs[r * bw + tid]);
                out[(size_t)r * W] = hv;
            }
        }
        __syncthreads();  // stage i % 2 is free before chunk i + 2 refills it
    }
    cp_async_wait<0>();  // no copy outlives the block
}

}  // namespace

// Bytes of shared memory the ring takes: 2 stages x (a, b) x rows x block_w f32.
extern "C" int repro_rglru_scan_smem_bytes(int rows, int block_w) {
    return 2 * 2 * rows * block_w * 4;
}

// a, b, h (B, S, W) contiguous f32; block_w threads per block (a multiple
// of 32, at most 1024); rows: time steps per ring stage.  vec: 1 when W % 4
// == 0 and a, b are 16-byte aligned.  Returns the launch's
// cudaGetLastError() code.
extern "C" int repro_rglru_scan_f32(const void* a, const void* b, void* h, int B, int S, int W,
                                    int rows, int block_w, int vec, void* stream) {
    if (B <= 0 || S <= 0 || W <= 0 || rows <= 0 || block_w <= 0 || block_w % 32 != 0 ||
        block_w > 1024)
        return (int)cudaErrorInvalidValue;
    const int smem = repro_rglru_scan_smem_bytes(rows, block_w);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((W + block_w - 1) / block_w, B);
    cudaError_t err;
    if (vec) {
        err = cudaFuncSetAttribute(rglru_scan_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            rglru_scan_kernel<true><<<grid, block_w, smem, st>>>(
                static_cast<const float*>(a), static_cast<const float*>(b),
                static_cast<float*>(h), S, W, rows);
    } else {
        err = cudaFuncSetAttribute(rglru_scan_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            rglru_scan_kernel<false><<<grid, block_w, smem, st>>>(
                static_cast<const float*>(a), static_cast<const float*>(b),
                static_cast<float*>(h), S, W, rows);
    }
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch's check reports it
        return (int)err;
    }
    return (int)cudaGetLastError();
}
