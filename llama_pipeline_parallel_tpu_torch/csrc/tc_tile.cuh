// The Hopper tensor-core tile product for bf16 operands: wgmma fed by TMA
// through a ring of shared-memory stages guarded by mbarriers, one producer
// warpgroup and two consumer warpgroups. fused_ce.cu's bf16 kernels (forward
// statistics, gradient, dh, dW) and fused_prologue.cu's bf16 forward,
// dhidden and dW use it; tc_matmul.cu wraps it bare, with a plain store, for
// the layout tests. flash_attention.cu's bf16 forward, dq and dk/dv use only
// its PTX wrappers (TMA from 3-D maps, mbarriers, setmaxnreg, wgmma with both
// operands in shared memory at N = 128, 64 and 32 and with A in registers at
// N = 128): their loops are their own.
//
// One block computes a BM x BN = 128 x 256 output tile
//   acc(i, j) = sum_k A(m0 + i, k) * B(n0 + j, k),   k in [0, K),
// in fp32 and hands the accumulator to an epilogue. Each operand is a bf16
// matrix in device memory, described by a TMA tensor map and stored
//   K-major : X(r, k) at p[r * ld + k] (the depth is contiguous), or
//   MN-major: X(r, k) at p[k * ld + r] (the rows are contiguous).
// wgmma reads either order from shared memory (its transpose flags), so no
// product needs a transposed copy in device memory.
//
// Shared memory. A stage holds one BK = 64 deep slice of both operands: A as
// two and B as four TMA boxes of 64 x 64 bf16 (8 KB each, 48 KB a stage), in
// the 128-byte swizzle (a box row is 128 bytes; within each 1024-byte atom of
// 8 rows the 16-byte chunks of row r are permuted by r % 8). A K-major box is
// 64 operand rows of 64 depth; an MN-major box is 64 depth rows of 64 operand
// rows. STAGES = 4 stages form the ring (1024-byte aligned, as the swizzle
// needs; 193 KB of the 227 KB a block may have, so one block per SM);
// full[s] completes when the TMA bytes of stage s have landed, empty[s] when
// both consumer warpgroups have released it.
//
// Why this shape: every product it serves is bound by the tensor cores
// (hundreds of operations per byte), so the design keeps them fed: TMA
// moves tiles without registers or instructions of the consumers, the ring
// keeps 3 stages of loads in flight behind the one being multiplied, and a
// 128 x 256 tile does 85 operations per byte it brings into shared memory
// where a 128 x 128 tile does 64: a quarter less L2 traffic for the same
// work (it ran faster for each of the three products on an H100).
//
// Roles. One thread of warpgroup 2 (the producer; setmaxnreg hands the
// warpgroup's registers to the consumers) waits for a free stage, announces
// its bytes on full[s] and issues the TMA loads. Warpgroups 0 and 1 own 64
// output rows each: wait for full[s], issue BK / 16 wgmma m64n256k16, commit,
// and release the previous step's stage once wgmma.wait_group 1 says its
// reads are done (never the stage the tensor cores may still be reading).
//
// Edges. TMA reads zeros past a tensor map's extents, so a ragged depth adds
// nothing and a map built over a sub-matrix (a vocab chunk) never reads its
// neighbour. Boxes wholly past the last output row or column are not loaded:
// the accumulator rows or columns they feed are never stored, and every
// store of an epilogue is masked.
//
// Accumulator layout of wgmma m64nNk16 (fp32): thread t of a warpgroup holds
//   d[4j + 2h + e] = acc(16 (t / 32) + (t % 32) / 4 + 8h, 8j + 2 (t % 4) + e)
// for h, e in {0, 1} and j in [0, N / 8). The epilogue is called with the
// thread's first output row and column; it owns rows row + 8h and columns
// col + 8j + e.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver entry is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lpt {
namespace tc {

constexpr int BM = 128;                    // output rows of a block: 64 per consumer warpgroup
constexpr int BN = 256;                    // output columns of a block
constexpr int BK = 64;                     // depth of a stage: one 128-byte swizzle row of bf16
constexpr int BOX = 64;                    // a TMA box is BOX x BOX bf16
constexpr uint32_t BOX_BYTES = BOX * BOX * 2;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;

constexpr uint32_t A_BYTES = (BM / BOX) * BOX_BYTES;
constexpr uint32_t STAGE_BYTES = A_BYTES + (BN / BOX) * BOX_BYTES;
// the ring, the slack to align it to 1024 bytes, and the 2 x STAGES mbarriers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 16 * STAGES;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box at coordinates (c0 along the contiguous dimension, c1 along rows).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D map at (c0, c1, c2): a box of rows of one layer (a head).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma that owns it.
template <int NA> __device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps registers that an asynchronous wgmma reads (a register A fragment)
// alive and unchanged until this point: call it after the wgmma.wait_group
// that retires the product, or the compiler may reuse them while the tensor
// cores still read them.
template <int NR> __device__ __forceinline__ void fence_regs(uint32_t (&r)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two fp32 values (x in the low half, y in the high) as two bf16x2 words,
// hi + lo: hi the pair rounded to bf16, lo what that rounding left out,
// rounded too; together about 16 significant bits where one bf16 holds 8. A
// pair of accumulator columns 2 (t % 4) + e becomes a pair of A-fragment
// columns of both words.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Descriptor of the 16-deep slice kk of one operand box in shared memory, in
// the 128-byte swizzle (layout type 1 in bits 62-63; addresses and offsets in
// 16-byte units). K-major: the slice is 32 bytes along every 128-byte row,
// 8-row atoms 1024 bytes apart (stride offset); the leading offset is unused.
// MN-major: the slice is 16 depth rows, i.e. two atoms (2048 bytes) further
// per kk; 64-wide chunks of the operand's rows lie `chunk` bytes apart (the
// leading offset: one box, or less for boxes of fewer depth rows), 8-deep
// atoms 1024 bytes apart (stride offset).
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t box, int kk,
                                                 uint32_t chunk = BOX_BYTES) {
  const uint32_t addr = MN ? box + kk * 2048 : box + kk * 32;
  const uint64_t lead = MN ? chunk : 16, stride = 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((lead >> 4) << 16) | ((stride >> 4) << 32) |
         (1ull << 62);
}

// d += A B^T for a 64 x BN tile, depth 16; TA / TB: the operand is MN-major.
template <bool TA, bool TB> struct Wgmma {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
        "%125, %126, %127},"
        " %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
          "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
          "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
          "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
          "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
          "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
          "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(int(TA)), "n"(int(TB)));
  }
};

// d (+)= A B^T for a 64 x N tile, depth 16, at N = 128, 64 and 32, both
// operands from shared memory (SS); TA / TB: the operand is MN-major;
// scale_d = 0 overwrites d instead of adding to it (the first depth slice).
template <int N, bool TA, bool TB> struct WgmmaSS;

// d += A B^T for a 64 x N tile, depth 16, at N = 128, A from registers
// (RS): the k16 A fragment, four bf16x2 words a thread, thread t of the
// warpgroup holding
//   a[h + 2g] = A(16 (t / 32) + (t % 32) / 4 + 8h, 8g + 2 (t % 4) + {0, 1}),
// which is the layout of columns 16kk .. 16kk + 15 of an fp32 accumulator
// (d[8kk + 2i], d[8kk + 2i + 1] -> a[i]) once packed to bf16x2: a product
// of an accumulator feeds the next without a shuffle. B from shared memory;
// TB: B is MN-major.
template <int N, bool TB> struct WgmmaRS;

template <bool TA, bool TB> struct WgmmaSS<128, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(int(TA)), "n"(int(TB)));
  }
};

template <bool TA, bool TB> struct WgmmaSS<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(int(TA)), "n"(int(TB)));
  }
};

template <bool TA, bool TB> struct WgmmaSS<32, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(int(TA)), "n"(int(TB)));
  }
};

template <bool TB> struct WgmmaRS<128, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t* a,
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(int(TB)));
  }
};

// ---------------------------------------------------------------------------
// The block's tile product
// ---------------------------------------------------------------------------

// The output tile at row m0, column n0 (multiples of BM and BN), in a block
// of THREADS threads with SMEM_BYTES of dynamic shared memory. A is M x K,
// B is N x K; A_MN / B_MN: the operand is MN-major. Calls epi(acc, row, col)
// in the consumer threads (see the accumulator layout above). A kernel that
// serves several products in one grid picks its maps, its N and its tile
// origin per block and calls this form.
template <bool A_MN, bool B_MN, class Epilogue>
__device__ __forceinline__ void tile_product_at(const CUtensorMap& map_a,
                                                const CUtensorMap& map_b, int m0, int n0, int M,
                                                int N, int K, const Epilogue& epi) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t ring = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  const int steps = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      const int a_boxes = min(BM / BOX, cdiv(M - m0, BOX));
      const int b_boxes = min(BN / BOX, cdiv(N - n0, BOX));
      const uint32_t bytes = (a_boxes + b_boxes) * BOX_BYTES;
      for (int step = 0; step < steps; ++step) {
        const int s = step % STAGES;
        mbar_wait(empty + 8 * s, ((step / STAGES) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, bytes);
        const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES;
        const int k0 = step * BK;
        for (int i = 0; i < a_boxes; ++i)
          tma_load(a + i * BOX_BYTES, &map_a, full + 8 * s, A_MN ? m0 + BOX * i : k0,
                   A_MN ? k0 : m0 + BOX * i);
        for (int i = 0; i < b_boxes; ++i)
          tma_load(b + i * BOX_BYTES, &map_b, full + 8 * s, B_MN ? n0 + BOX * i : k0,
                   B_MN ? k0 : n0 + BOX * i);
      }
    }
  } else {
    // consumers: warpgroup wg owns output rows m0 + 64 wg .. + 63, i.e. A's box wg
    setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int step = 0; step < steps; ++step) {
      const int s = step % STAGES;
      mbar_wait(full + 8 * s, (step / STAGES) & 1);
      const uint32_t stage = ring + s * STAGE_BYTES;
      const uint32_t a = stage + wg * BOX_BYTES, b = stage + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<A_MN, B_MN>::run(acc, operand_desc<A_MN>(a, kk), operand_desc<B_MN>(b, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done reading their stage
      if (step > 0) mbar_arrive(empty + 8 * ((step - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    epi(acc, m0 + 64 * wg + 16 * warp + lane / 4, n0 + 2 * (lane % 4));
  }
}

// The tile of a grid of (cdiv(M, BM), cdiv(N, BN)) blocks that one product
// covers: row tile blockIdx.x, column tile blockIdx.y.
template <bool A_MN, bool B_MN, class Epilogue>
__device__ __forceinline__ void tile_product(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                             int M, int N, int K, const Epilogue& epi) {
  tile_product_at<A_MN, B_MN>(map_a, map_b, blockIdx.x * BM, blockIdx.y * BN, M, N, K, epi);
}

// ---------------------------------------------------------------------------
// An epilogue both sources share
// ---------------------------------------------------------------------------

// out[i, j] (+)= acc in fp32 over an M x N output (N a multiple of 2: each
// column pair is one 8-byte word): the first of several products into one
// output writes it, the later ones add (CE vocab chunks, the prologue's
// q, k and v projections).
struct DhStore {
  float* __restrict__ out;
  int m, n, accumulate;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int c = col + 8 * j;
        if (c >= n) continue;
        float2* p = reinterpret_cast<float2*>(out + (size_t)r * n + c);
        float2 val = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (accumulate) {
          const float2 old = *p;
          val.x += old.x;
          val.y += old.y;
        }
        *p = val;
      }
    }
  }
};

// out[i, c0 + j] = acc rounded to bf16 over an M x N output whose rows are
// ld elements apart (N, c0 and ld even: each column pair is one 4-byte
// word): the CE head's dW (a vocab chunk of dW) and the prologue's q, k, v
// and dwq, dwk, dwv.
struct BfStore {
  __nv_bfloat16* __restrict__ out;
  int m, ld, c0, n;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int c = col + 8 * j;
        if (c >= n) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + c0 + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 matrix of `rows` rows of `cols` contiguous
// elements, rows `ld` elements apart, read in BOX x BOX boxes in the
// 128-byte swizzle with zeros past its edges. TMA needs p and ld * 2 to be
// multiples of 16 bytes.
inline cudaError_t make_map(CUtensorMap* map, const void* p, int cols, int rows, size_t ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {BOX, BOX}, elems[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                            strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a bf16 array of `layers` x `rows` rows of `cols`
// contiguous elements, all contiguous, read in boxes of BOX columns x
// `box_rows` rows of one layer in the 128-byte swizzle with zeros past its
// edges: a box never reads the next layer's rows. TMA needs p and cols * 2
// to be multiples of 16 bytes.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* p, int cols, int rows, int layers,
                               int box_rows = BOX) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1}, elems[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
                            strides, box, elems, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch a kernel built on tile_product_at over a grid of (row_tiles,
// col_tiles) blocks.
template <class... Params, class... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int row_tiles, int col_tiles,
                         cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_tiles, col_tiles), THREADS, SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// Launch a kernel built on tile_product over an M x N output.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int M, int N, cudaStream_t stream, Args... args) {
  return launch_tiles(kernel, cdiv(M, BM), cdiv(N, BN), stream, args...);
}

}  // namespace tc
}  // namespace lpt
