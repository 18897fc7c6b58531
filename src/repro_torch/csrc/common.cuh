// Shared helpers of the port's CUDA kernels: cp.async staging, warp
// reductions, bf16 unpacking, and the error-name export of each library.
//
// Each kernel source is compiled on its own into one shared library with a
// plain C interface (see repro_torch/kernels/_build.py), so the exported
// function below is defined once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// The JAX kernels' masked-score value: finite, so exp(NEG_INF - NEG_INF) = 1
// on a row that is masked so far; the mask then zeroes it explicitly.
#define REPRO_NEG_INF (-1e30f)

extern "C" const char* repro_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared.  src_bytes = 0 reads nothing
// and fills the 16 bytes with zeros (rows past the valid range).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}

// 4-byte asynchronous copy global -> shared (through L1: .cg takes only
// 16 bytes), for rows whose stride is not a multiple of 16 bytes.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Wait until at most n committed groups are still in flight.  wait_group
// takes an immediate, so a run-time n goes through a switch; past 15 it
// waits for all, which is correct and only overlaps less.
__device__ __forceinline__ void cp_async_wait_n(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        case 4: cp_async_wait<4>(); break;
        case 5: cp_async_wait<5>(); break;
        case 6: cp_async_wait<6>(); break;
        case 7: cp_async_wait<7>(); break;
        case 8: cp_async_wait<8>(); break;
        case 9: cp_async_wait<9>(); break;
        case 10: cp_async_wait<10>(); break;
        case 11: cp_async_wait<11>(); break;
        case 12: cp_async_wait<12>(); break;
        case 13: cp_async_wait<13>(); break;
        case 14: cp_async_wait<14>(); break;
        case 15: cp_async_wait<15>(); break;
        default: cp_async_wait<0>(); break;
    }
}

// Butterfly reductions: every lane gets the result, in a fixed order.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// Eight bf16 values from one 16-byte shared-memory read.
__device__ __forceinline__ void unpack_bf16x8(const bf16* p, float f[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h2[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
    }
}

// Round to bf16 and back: the probabilities enter the PV product in the
// value dtype, as the TPU kernels cast them (p.astype(v.dtype)).
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// dot(q[0:8], k[0:8]) accumulated onto acc in index order.
__device__ __forceinline__ float dot8(const float* q, const float k[8], float acc) {
    const float4 a = *reinterpret_cast<const float4*>(q);
    const float4 b = *reinterpret_cast<const float4*>(q + 4);
    acc = fmaf(a.x, k[0], acc);
    acc = fmaf(a.y, k[1], acc);
    acc = fmaf(a.z, k[2], acc);
    acc = fmaf(a.w, k[3], acc);
    acc = fmaf(b.x, k[4], acc);
    acc = fmaf(b.y, k[5], acc);
    acc = fmaf(b.z, k[6], acc);
    acc = fmaf(b.w, k[7], acc);
    return acc;
}
