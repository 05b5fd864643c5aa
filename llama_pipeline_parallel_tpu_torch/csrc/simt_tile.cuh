// The tiled SIMT product shared by the kernels of fused_ce.cu and
// fused_prologue.cu: one block computes a TILE x TILE output tile
// acc[r][c] += sum_k A(m0 + micro(ty, r), k) * B(n0 + micro(tx, c), k)
// with scalar fp32 FMAs.
//
// A and B are operands: small structs with `float operator()(int r, int k)`
// that give one element as fp32 (a plain load, or a load with a transform
// such as a norm or an un-rotation applied on the way in) and
// `static constexpr bool kContig`, true when neighbouring k are neighbouring
// addresses. kContig only decides which elements neighbouring threads load,
// so that they read neighbouring addresses.
//
// Mainloop: depth BK = 16 per step, fp32 copies of both [BK, TILE] tiles in
// shared memory, an 8 x 8 register micro-tile per thread fed by float4
// loads, and the next depth tile's global loads in flight during this tile's
// FMAs. Elements past the rows, columns or depth are zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lpt {

constexpr int TILE = 128;        // rows and columns of a block's output tile
constexpr int BK = 16;           // depth of one mainloop step
constexpr int NT = 256;          // threads per block, seen as a 16 x 16 grid
constexpr int LDT = TILE + 4;    // row stride of a [BK, TILE] operand tile in shared memory

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T (to nearest even), as fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Offset of a thread's micro-tile row (or column) r in 0..7 inside the tile:
// rows q * 4 .. q * 4 + 3 and 64 + q * 4 .. 64 + q * 4 + 3 for thread
// coordinate q (ty for rows, tx for columns).
__device__ __forceinline__ int micro(int q, int r) { return (r < 4 ? 0 : 64) + q * 4 + (r & 3); }

// A matrix stored K-contiguous (p[r * ld + k]) or R-contiguous (p[k * ld + r]).
template <typename T, bool K_CONTIG>
struct Dense {
  static constexpr bool kContig = K_CONTIG;
  const T* __restrict__ p;
  size_t ld;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return to_f32(p[K_CONTIG ? (size_t)r * ld + k : (size_t)k * ld + r]);
  }
};

struct TileSmem {
  float a[BK][LDT];
  float b[BK][LDT];
};

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
}

// Which element (r, k) of a [TILE, BK] tile this thread loads as its e-th.
template <bool K_CONTIG>
__device__ __forceinline__ void tile_coords(int e, int& r, int& k) {
  if (K_CONTIG) {
    r = e * 16 + threadIdx.x / 16;
    k = threadIdx.x % 16;
  } else {
    r = threadIdx.x % TILE;
    k = e * 2 + threadIdx.x / TILE;
  }
}

template <class Op>
__device__ __forceinline__ void load_tile(float (&reg)[8], const Op& x, int r0, int k0, int rows,
                                          int depth) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int r, k;
    tile_coords<Op::kContig>(e, r, k);
    const int gr = r0 + r, gk = k0 + k;
    reg[e] = (gr < rows && gk < depth) ? x(gr, gk) : 0.f;
  }
}

template <bool K_CONTIG>
__device__ __forceinline__ void store_tile(float (*s)[LDT], const float (&reg)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int r, k;
    tile_coords<K_CONTIG>(e, r, k);
    s[k][r] = reg[e];
  }
}

// acc[r][c] += sum_k A(m0 + micro(ty, r), k) * B(n0 + micro(tx, c), k) over
// k in [0, K). A has M rows, B has N rows (the output's columns).
template <class OpA, class OpB>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], TileSmem& s, const OpA& a,
                                             const OpB& b, int m0, int n0, int M, int N, int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float ra[8], rb[8];
  load_tile(ra, a, m0, 0, M, K);
  load_tile(rb, b, n0, 0, N, K);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile<OpA::kContig>(s.a, ra);
    store_tile<OpB::kContig>(s.b, rb);
    __syncthreads();
    if (k0 + BK < K) {  // the next depth tile's loads fly while this one's FMAs run
      load_tile(ra, a, m0, k0 + BK, M, K);
      load_tile(rb, b, n0, k0 + BK, N, K);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();  // every read of this tile is done before the next store
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace lpt

// dtype: 0 = float32, 1 = bfloat16.
#define LPT_DISPATCH(DTYPE, CALL)                              \
  do {                                                         \
    if ((DTYPE) == 0) return (int)CALL(float);                 \
    if ((DTYPE) == 1) return (int)CALL(__nv_bfloat16);         \
    return (int)cudaErrorInvalidValue;                         \
  } while (0)
