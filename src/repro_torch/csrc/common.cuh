// Shared helpers of the port's CUDA kernels: cp.async staging, bf16
// unpacking, the warp-level mma.sync product with its ldmatrix loads, and the
// error-name export of each library.
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

// ---------------------------------------------------------------------------
// mma.sync (sm_80 and later): one warp's 16 x 8 x 16 bf16 product
// ---------------------------------------------------------------------------

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] receives lane's fragment of it (row
// lane / 4, columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row))
                 : "memory");
}

// The same, transposed: r[i] receives rows 2 (lane % 4) and + 1 of column
// lane / 4 (a B fragment from a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row))
                 : "memory");
}

// d += a b: a 16 x 16 row-major bf16 (a[0]: row lane / 4, columns 2 (lane %
// 4) + {0, 1}; a[1]: row + 8; a[2], a[3]: columns + 8), b 16 x 8 column-major
// (b[0]: k rows 2 (lane % 4) + {0, 1} of column lane / 4; b[1]: k + 8), d
// 16 x 8 f32 (d[0], d[1]: row lane / 4, columns 2 (lane % 4) + {0, 1};
// d[2], d[3]: row + 8).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, the first in the low half (an
// A fragment's column order).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}
