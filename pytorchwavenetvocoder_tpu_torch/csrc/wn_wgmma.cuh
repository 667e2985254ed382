// The product core of the layer-stack kernels (csrc/layer_stack_fwd.cu,
// csrc/layer_stack_bwd.cu): persistent warp-specialised bf16 GEMM tiles on
// Hopper's wgmma, fed by TMA through a ring of shared-memory stages.
//
// A block owns one 128 x BN f32 output tile (BN = 128 or 256, the
// problem's) at a time and walks over
// tiles ("items") blockIdx.x, + gridDim.x, ...; one or two blocks per SM
// (the problem's BLOCKS).  Its 288
// threads are two consumer warpgroups (rows 0-63 and 64-127 of the tile)
// and one producer warp.  Lane 0 of the producer issues, for every K step
// of 64, one 16 KB A tile and one BN x 64 B tile as TMA loads into the
// next free ring stage, completing on that stage's "full" mbarrier; the
// consumers run four wgmma.m64nBNk16 (bf16 -> f32) on the stage, keep one
// group in flight and release the stage before it on its "empty" mbarrier
// (one arrival per consumer warp).  The producer runs ahead into the next
// item while the consumers run the epilogue of the last one, straight from
// the accumulator registers.
//
// Operand layouts (all loaded by TMA with the 128-byte swizzle, which the
// wgmma descriptors name):
//   * K-major ("row products": the activations' rows times packed or
//     row-major weights): a tile is 128 rows x 64 K values, each row 128
//     bytes; wgmma k-steps advance the start address by 32 bytes.
//   * MN-major (the weight-gradient products, K = the data rows): the
//     transposed operands are read from the same row-major activation
//     tiles, no transposed copies: a tile is boxes of 64 K rows x 64 M (or
//     N) columns, 8 KB each; k-steps advance by 16 rows, 2,048 bytes; each
//     next box lies one leading-dimension offset (8 KB) on.
// A problem class P supplies the work: items(), ksteps(item), load(item,
// ks, A tile, B tile, barrier) (one thread, exactly one stage's bytes of
// TMA), prefetch(item, frag, Pre&) (the epilogue's own global loads, into
// registers, before the item's products), epilogue(item, acc, ..., Pre),
// its two layouts A_MN, B_MN, its BN and its BLOCKS.
#pragma once

#include <cuda.h>

#include "wn_hopper.cuh"

#define WG_BM 128              // output rows per item
#define WG_BK 64               // K per ring stage (128 bytes of bf16)
#define WG_CONSUMERS 256       // two warpgroups
#define WG_THREADS (WG_CONSUMERS + 32)
#define WG_A_BYTES (WG_BM * WG_BK * 2)          // 16 KB: the A tile of a stage
#define WG_SCRATCH_BYTES (2 * 8 * 128 * 4)      // epilogue column sums

// The ring of a problem whose items are BN (128 or 256) columns wide and
// which runs BLOCKS blocks per SM: a stage holds the 16 KB A tile and a
// BN x 64 B tile.  BN = 256: four stages of 48 KB (~201 KB), one block per
// SM (128 accumulators a thread); BN = 128: six stages of 32 KB, or three
// (~105 KB) where two blocks share an SM, so that one block's epilogue
// runs beside the other's products
template <int BN, int BLOCKS>
struct WgRing {
    static constexpr int B_BYTES = BN * WG_BK * 2;
    static constexpr int STAGE = WG_A_BYTES + B_BYTES;
    static constexpr int STAGES = BN == 256 ? 4 : 6 / BLOCKS;
    static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8
                              + WG_SCRATCH_BYTES;
};

// ---- device: barriers, TMA, wgmma ------------------------------------------
static __device__ __forceinline__ void mbar_init_count(uint64_t* bar, unsigned n) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(n));
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(smem_addr(bar)) : "memory");
}

// mbar_wait that traps instead of spinning for ever: no healthy wait of
// these kernels lasts a millisecond, 2^26 polls last seconds, and a fault
// in a plan then surfaces as a launch error, not a hung card
static __device__ __forceinline__ void wg_wait(uint64_t* bar, unsigned parity) {
    for (long long i = 0;; ++i) {
        unsigned done;
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (done) return;
        if (i > (1ll << 26)) __trap();
    }
}

// a 3-D tile (c0 innermost) of a tensor map into shared memory; rows and
// columns outside the tensor, negative coordinates included, read as zeros
static __device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1,
                                                   int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0),
          "r"(c1), "r"(c2)
        : "memory");
}

// a 2-D tile (c0 innermost) of a tensor map into shared memory; rows and
// columns outside the tensor read as zeros
static __device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0),
          "r"(c1)
        : "memory");
}

// the 256 consumer threads only (the producer warp never joins)
static __device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
static __device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo,
                                                   unsigned sbo) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32)
         | (1ull << 62);
}

// descriptor of k-step kk (16 deep) of a 64-deep operand tile
template <int MN>
static __device__ __forceinline__ uint64_t wg_operand(const unsigned char* tile,
                                                      int kk) {
    return MN ? wg_desc(tile + kk * 2048, 8192, 1024)
              : wg_desc(tile + kk * 32, 16, 1024);
}

static __device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32, the warpgroup's fragment) (+)= A (64 x 16) B (16 x 128);
// TA / TB: 1 for an MN-major operand
template <int TA, int TB>
static __device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
static __device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));

}

template <int BN, int TA, int TB>
static __device__ __forceinline__ void wgmma_n(float (&d)[BN / 2], uint64_t da,
                                               uint64_t db, int scale_d) {
    if constexpr (BN == 256)
        wgmma_256<TA, TB>(d, da, db, scale_d);
    else
        wgmma_128<TA, TB>(d, da, db, scale_d);
}

// Narrower K-major products (both operands K-major, 128-byte swizzle), for
// the AR kernel's streamed gate (csrc/ar_persistent.cu): d (64 x N, the
// warpgroup's fragment, laid out as below) (+)= A (64 x 16) B (16 x N) in
// bf16 into f32, or A (64 x 32) B (32 x N) in s8 into s32 (exact).
static __device__ __forceinline__ void wgmma_bf16_n16(float (&d)[8], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_s8_n16(int (&d)[8], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

static __device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
        uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// Where accumulator d[4 j + q] of a consumer thread lies in the 128 x BN
// item: row wg*64 + (warp%4)*16 + lane/4 (+8 for q >= 2), column 8 j +
// 2 (lane%4) + (q & 1).
struct WgFrag {
    int row, col;     // of d[0]: add 8 to the row for q >= 2, 8 j + (q & 1)
                      // to the column
};

static __device__ __forceinline__ WgFrag wg_frag(int ctid) {
    const int lane = ctid & 31, warp = ctid >> 5;
    return {warp * 16 + (lane >> 2), 2 * (lane & 3)};
}

// 4 x 4 transpose of 32-bit words within each quad of lanes (4r .. 4r+3,
// which share the accumulator rows): on entry v[g] is this lane's word
// (its column pair) of 8-column group g; on exit v[p] is lane p's word of
// group lane % 4, so that the lane holds 8 consecutive columns of one
// group and stores them as one 16-byte vector.  Its own inverse (a 16-byte
// load by group, transposed, gives each lane its pairs).  Every lane of
// the warp must call it.
static __device__ __forceinline__ uint32_t wg_pick(const uint32_t (&v)[4], int i) {
    return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

static __device__ __forceinline__ void quad_transpose(uint32_t (&v)[4]) {
    const int q = threadIdx.x & 3;
    uint32_t r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)   // lane q ^ k wants our word of group q ^ k
        r[k] = __shfl_xor_sync(0xffffffffu, wg_pick(v, q ^ k), k);
#pragma unroll
    for (int p = 0; p < 4; ++p) v[p] = wg_pick(r, p ^ q);   // r[k]: lane q ^ k's
}

static __device__ __forceinline__ uint32_t bf2_bits(float lo, float hi) {
    const __nv_bfloat162 v = __halves2bfloat162(f2bf(lo), f2bf(hi));
    return *(const uint32_t*)&v;
}

static __device__ __forceinline__ float2 bits_bf2(uint32_t w) {
    const __nv_bfloat162 v = *(const __nv_bfloat162*)&w;
    return make_float2(__low2float(v), __high2float(v));
}

// ---- the persistent kernel ---------------------------------------------------
template <class P>
__global__ void __launch_bounds__(WG_THREADS, P::BLOCKS)
wg_kernel(const __grid_constant__ P p) {
    typedef WgRing<P::BN, P::BLOCKS> Ring;
    extern __shared__ unsigned char wg_smem_raw[];
    unsigned char* smem = (unsigned char*)(((uintptr_t)wg_smem_raw + 1023)
                                           & ~(uintptr_t)1023);
    uint64_t* full = (uint64_t*)(smem + Ring::STAGES * Ring::STAGE);
    uint64_t* empty = full + Ring::STAGES;
    unsigned char* scratch = (unsigned char*)(empty + Ring::STAGES);
    if (threadIdx.x == 0) {
        for (int s = 0; s < Ring::STAGES; ++s) {
            mbar_init_count(&full[s], 1);
            mbar_init_count(&empty[s], WG_CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int n_items = p.items();

    if (threadIdx.x >= WG_CONSUMERS) {
        // producer: one lane keeps the ring full
        if (threadIdx.x == WG_CONSUMERS) {
            int stage = 0;
            unsigned phase = 0;
            for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
                const int nk = p.ksteps(it);
                for (int ks = 0; ks < nk; ++ks) {
                    wg_wait(&empty[stage], phase ^ 1);
                    unsigned char* st = smem + stage * Ring::STAGE;
                    mbar_expect(&full[stage], Ring::STAGE);
                    p.load(it, ks, st, st + WG_A_BYTES, &full[stage]);
                    if (++stage == Ring::STAGES) { stage = 0; phase ^= 1; }
                }
            }
        }
        return;
    }

    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    WgFrag f = wg_frag(threadIdx.x & 127);
    f.row += wg * 64;
    int stage = 0;
    unsigned phase = 0;
    float acc[P::BN / 2];
#pragma unroll
    for (int i = 0; i < P::BN / 2; ++i) acc[i] = 0.f;
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const int nk = p.ksteps(it);
        // the epilogue's own loads, issued before the products hide them
        typename P::Pre pre;
        p.prefetch(it, f, pre);
        int prev = -1;
        for (int ks = 0; ks < nk; ++ks) {
            wg_wait(&full[stage], phase);
            const unsigned char* sa = smem + stage * Ring::STAGE + wg * (WG_A_BYTES / 2);
            const unsigned char* sb = smem + stage * Ring::STAGE + WG_A_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < WG_BK / 16; ++kk)
                wgmma_n<P::BN, P::A_MN, P::B_MN>(acc, wg_operand<P::A_MN>(sa, kk),
                                                 wg_operand<P::B_MN>(sb, kk),
                                                 (ks | kk) != 0);
            wgmma_commit();
            if (prev >= 0) {
                wgmma_wait<1>();
                if (lane == 0) mbar_arrive(&empty[prev]);
            }
            prev = stage;
            if (++stage == Ring::STAGES) { stage = 0; phase ^= 1; }
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[prev]);
        p.epilogue(it, acc, f, threadIdx.x, scratch, pre);
    }
}

// Two problems of one operand layout and tile shape as one launch: items
// [0, n1) are P1's, the rest P2's (a launch's tail filled by the other's
// items, and one launch fewer)
template <class P1, class P2>
struct WgBoth {
    static_assert(P1::A_MN == P2::A_MN && P1::B_MN == P2::B_MN && P1::BN == P2::BN
                      && P1::BLOCKS == P2::BLOCKS,
                  "one launch runs one layout and tile shape");
    static constexpr int A_MN = P1::A_MN, B_MN = P1::B_MN, BN = P1::BN,
                         BLOCKS = P1::BLOCKS;
    P1 p1;
    P2 p2;
    int n1;

    __device__ int items() const { return n1 + p2.items(); }
    __device__ int ksteps(int it) const {
        return it < n1 ? p1.ksteps(it) : p2.ksteps(it - n1);
    }
    __device__ void load(int it, int ks, unsigned char* sa, unsigned char* sb,
                         uint64_t* bar) const {
        if (it < n1) p1.load(it, ks, sa, sb, bar);
        else p2.load(it - n1, ks, sa, sb, bar);
    }
    struct Pre {
        typename P1::Pre a;
        typename P2::Pre b;
    };
    __device__ void prefetch(int it, WgFrag f, Pre& pre) const {
        if (it < n1) p1.prefetch(it, f, pre.a);
        else p2.prefetch(it - n1, f, pre.b);
    }
    __device__ void epilogue(int it, const float (&acc)[BN / 2], WgFrag f, int tid,
                             unsigned char* scratch, const Pre& pre) const {
        if (it < n1) p1.epilogue(it, acc, f, tid, scratch, pre.a);
        else p2.epilogue(it - n1, acc, f, tid, scratch, pre.b);
    }
};

// ---- host -------------------------------------------------------------------
typedef CUresult (*wg_encode_fn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static wg_encode_fn wg_encoder() {
    static wg_encode_fn fn = nullptr;
    if (!fn) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                             cudaEnableDefault, &q) != cudaSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                    &q) != cudaSuccess)
            return nullptr;
#endif
        if (q != cudaDriverEntryPointSuccess) return nullptr;
        fn = (wg_encode_fn)f;
    }
    return fn;
}

// A bf16 tensor seen as (planes, rows, inner), inner contiguous, as a TMA
// map whose box is 64 inner values x box_rows rows x 1 plane, with the
// 128-byte swizzle; reads outside it are zeros.  Returns 0 on success.
static int wg_map(CUtensorMap* m, const void* ptr, long long inner, long long rows,
                  long long planes, int box_rows) {
    wg_encode_fn enc = wg_encoder();
    if (!enc) return (int)cudaErrorNotSupported;
    if (inner % 8 != 0 || ((uintptr_t)ptr & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                                (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                   (cuuint64_t)inner * rows * 2};
    const cuuint32_t box[3] = {64u, (cuuint32_t)box_rows, 1u};
    const cuuint32_t estr[3] = {1u, 1u, 1u};
    const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)ptr, dims,
                           strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A 2-D tensor of rows of `inner` elements of `elem` bytes (bf16: 2, int8:
// 1), rows `row_bytes` apart, as a TMA map whose box is 128 bytes of a row
// x box_rows rows, with the 128-byte swizzle; reads outside it are zeros.
// Returns 0 on success.
static int wg_map_2d(CUtensorMap* m, const void* ptr, int elem, long long inner,
                     long long rows, long long row_bytes, int box_rows) {
    wg_encode_fn enc = wg_encoder();
    if (!enc) return (int)cudaErrorNotSupported;
    if ((elem != 1 && elem != 2) || row_bytes % 16 != 0 || inner * elem > row_bytes
        || ((uintptr_t)ptr & 15) != 0 || box_rows < 1 || box_rows > 256)
        return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1u, 1u};
    const CUresult r = enc(m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                           2, (void*)ptr, dims, strides, box, estr,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static int wg_sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 132;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 132;
    return n;
}

// one persistent launch of P's items; returns cudaGetLastError()
template <class P>
static int wg_launch(const P& p, int n_items, cudaStream_t s) {
    static bool attr = false;
    if (!attr) {
        const cudaError_t e = cudaFuncSetAttribute(
            wg_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            WgRing<P::BN, P::BLOCKS>::SMEM);
        if (e != cudaSuccess) return (int)e;
        attr = true;
    }
    if (n_items <= 0) return 0;
    const int slots = wg_sm_count() * P::BLOCKS;
    const int grid = n_items < slots ? n_items : slots;
    wg_kernel<P><<<grid, WG_THREADS, WgRing<P::BN, P::BLOCKS>::SMEM, s>>>(p);
    return (int)cudaGetLastError();
}
