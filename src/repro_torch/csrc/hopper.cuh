// Hopper (sm_90a) building blocks shared by the tensor-core kernels, as
// raw PTX: mbarriers, TMA tile loads, wgmma shared-memory descriptors for
// the 128-byte swizzle, the wgmma bf16 -> f32 products the kernels issue,
// and the host-side encoding of a TMA tensor map.
//
// The layout every kernel here uses: a tile is a stack of 128-byte rows
// (64 bf16) that TMA writes under CU_TENSOR_MAP_SWIZZLE_128B, so eight rows
// make one 1024-byte swizzle atom.  A tile wider than 64 elements loads as
// 64-column slabs, one TMA box each, placed one after the other.  Every
// tile and slab starts on a 1024-byte boundary of shared memory (the
// kernels round the dynamic base up), and so does every descriptor base but
// the K-major one advanced by 32 bytes per 16-element k step inside a row,
// which the swizzle's address bits allow.
//
//   K-major operand (A = x rows, Q rows, K rows): start + 32 * (k16 % 4)
//     in slab k16 / 4, SBO = 1024 (8 rows), LBO unused (1).
//   MN-major operand (B = w rows, V rows; transpose bit set): start +
//     2048 * k16 (16 rows of 128 bytes), SBO = 1024 (8 rows along K), LBO =
//     the slab stride (the next 64 columns along N).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <stdio.h>

#include "common.cuh"

namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the other threads and to the
// async proxy (TMA); call after the inits, before a block barrier.
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that has
// not completed after ~2^34 cycles (seconds) traps: a lost copy or arrival
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done;
    const long long t0 = clock64();
    for (;;) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 34)) __trap();
    }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a tile global -> shared; the barrier counts its bytes
// (out-of-bounds elements are written as zeros and counted too)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
           "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor under the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
    uint64_t d = 0;
    d |= (uint64_t)((smem_addr(smem) & 0x3FFFF) >> 4);
    d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
    d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
    d |= (uint64_t)1 << 62;
    return d;
}

// Order register writes before the next wgmma (A fragments, accumulators).
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers in place around wgmma: the compiler may not move reads or
// writes of them across this point (the products write them asynchronously,
// which the compiler cannot see).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Two f32 -> one register of two bf16 (lo: the lower column), the A
// fragment of a register-sourced wgmma.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup:
//   d[4j + e] is row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2),
//             column 8 * j + 2 * (t % 4) + (e % 2).
// The register A fragment of m64n*k16 (four registers of two bf16) takes
// row/column pairs in the same pattern over 16 columns, so the accumulator of
// one product (columns 16 kk .. 16 kk + 15) feeds the next as
//   a[r] = pack(d[8 kk + 2 r], d[8 kk + 2 r + 1]).

// D (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared); TB = 1: B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, shared) * B (16 x 128, shared); TB = 1: B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31,\n"
        " %32, %33, %34, %35, %36, %37, %38, %39,\n"
        " %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55,\n"
        " %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "%64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared); TB = 1: B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared); TB = 1: B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31,\n"
        " %32, %33, %34, %35, %36, %37, %38, %39,\n"
        " %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55,\n"
        " %56, %57, %58, %59, %60, %61, %62, %63"
        "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// D (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, shared); TB = 1: B is MN-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        " %8, %9, %10, %11, %12, %13, %14, %15,\n"
        " %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31,\n"
        " %32, %33, %34, %35, %36, %37, %38, %39,\n"
        " %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55,\n"
        " %56, %57, %58, %59, %60, %61, %62, %63,\n"
        " %64, %65, %66, %67, %68, %69, %70, %71,\n"
        " %72, %73, %74, %75, %76, %77, %78, %79,\n"
        " %80, %81, %82, %83, %84, %85, %86, %87,\n"
        " %88, %89, %90, %91, %92, %93, %94, %95,\n"
        " %96, %97, %98, %99, %100, %101, %102, %103,\n"
        " %104, %105, %106, %107, %108, %109, %110, %111,\n"
        " %112, %113, %114, %115, %116, %117, %118, %119,\n"
        " %120, %121, %122, %123, %124, %125, %126, %127"
        "}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TB));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the libraries link only
// the runtime, so it is reached through the runtime's driver entry point.
inline EncodeTiledFn encode_tiled_fn() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) {
            cudaGetLastError();
            return nullptr;
        }
        fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) over `ptr`, with the
// byte strides of dims 1.. and a box of `box` elements, 128-byte swizzle,
// out-of-bounds elements read as zeros.  Returns a cudaError_t code.
inline int encode_bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                           const uint64_t* strides_bytes, const uint32_t* box) {
    EncodeTiledFn fn = encode_tiled_fn();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr),
                    reinterpret_cast<const cuuint64_t*>(dims),
                    reinterpret_cast<const cuuint64_t*>(strides_bytes),
                    reinterpret_cast<const cuuint32_t*>(box), elem_strides,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
        fprintf(stderr, "cuTensorMapEncodeTiled: CUresult %d (rank %d)\n", (int)r, rank);
        return (int)cudaErrorInvalidValue;
    }
    return 0;
}

}  // namespace hopper
