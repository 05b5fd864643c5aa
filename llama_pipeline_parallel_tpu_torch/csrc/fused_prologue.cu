// Fused RMSNorm -> QKV -> RoPE prologue for Hopper: forward, dhidden and dW.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/pallas_prologue.py:
//   prologue_rstd_kernel + prologue_fwd_kernel  <- _fwd_kernel (pallas_call in _fwd)
//     in bf16 on the tensor cores: prologue_norm_kernel + prologue_fwd_tc_kernel
//   prologue_dhidden_kernel                     <- _dhidden_kernel (first pallas_call in _bwd)
//     in bf16 on the tensor cores: prologue_unrope_kernel + prologue_dhidden_tc_kernel
//   prologue_rstd_kernel + prologue_dw_kernel   <- _dw_kernel (second pallas_call in _bwd)
//     in bf16 on the tensor cores: prologue_norm_kernel + prologue_unrope_kernel
//     + prologue_dw_tc_kernel
//
// What they compute is the TPU kernels' contract, not their block structure.
// With x [n, d], the norm weight nw [d] (fp32), wq [d, hq hd], wk and wv
// [d, hkv hd], cos and sin [n, hd], all but nw in the compute dtype T, and
// round() meaning "rounded to T":
//   rstd   = 1 / sqrt(mean_f x[t, f]^2 + eps)  (fp64, rounded once to fp32)
//   hidden = round(nw[f] * (x[t, f] * rstd[t]))     (ops/rmsnorm.py's formula)
//   q = rope(round(hidden wq)), k = rope(round(hidden wk)), v = round(hidden wv),
//   rope(p)[j] = round(round(p[j] cos[j]) + round(rot(p)[j] sin[j])),
//   rot(p) = concat(-p[hd/2:], p[:hd/2]) per head (HF rotate_half);
//   dhidden = unrope(dq) wq^T + unrope(dk) wk^T + dv wv^T     (fp32 out)
//   dwq = hidden^T unrope(dq), dwk = hidden^T unrope(dk), dwv = hidden^T dv (out in T),
//   unrope(y)[j] = round(round(y[j] cos[j]) + rt[j]), rt = concat(ys[hd/2:], -ys[:hd/2]),
//   ys = round(y sin): the transpose of rope. Products accumulate in fp32.
// On the SIMT route the normed hidden and the pre-RoPE q, k and their
// cotangents never reach device memory: each is formed from x (or dq, dk) as
// its tile is loaded. The tensor-core route writes the normed hidden and the
// un-rotated cotangents to call-lived scratches (below).
//
// Why not the TPU's blocks. The TPU kernels hold wq, wk and wv whole in VMEM
// (sized for tp-sharded layers) and the dW kernel carries fp32 [d, width]
// accumulators across a sequential grid over the tokens. At LLaMA-7B width
// one projection is 33.5 MB in bf16, against the 227 KB of shared memory a
// Hopper block has, and blocks run in no order. So here every kernel tiles
// its output into 128 x 128 tiles, one block and one writer each (no
// atomics, no zero-fill), over the tiled mainloop of simt_tile.cuh:
// - row statistics: prologue_rstd_kernel, one warp per token, writes rstd to
//   an [n] fp32 scratch before the forward and dW products, so that each
//   loaded x element is normed and rounded to T before the product, as the
//   TPU kernel's _norm_block does. The sum of squares is taken in fp64 and
//   rstd rounded to fp32 once, so no summation order changes it: in fp32 the
//   order moved rstd by an ulp on 2/3 of the rows at LLaMA-7B width, which
//   flipped ~1e-5 of the bf16 normed hidden by one step against any other
//   implementation. The cost is nil: the pass reads x once.
// - forward: a block per (token tile) x (head of q, then k, then v). A
//   column tile is one whole head (hd = 128 = TILE), and the micro-tile
//   layout gives each thread columns j and j + 64 together, the rotate_half
//   partners: the RoPE epilogue needs no exchange between threads.
// - dhidden: a block per (token tile) x (128 features of d); the depth runs
//   over wq's, then wk's, then wv's columns (12,288 at LLaMA-7B width) into
//   one fp32 accumulator. dq and dk are un-rotated as they are loaded (each
//   element reads its partner column and cos, sin).
// - dW: a block per (128 features of d) x (head of dwq, then dwk, then dwv)
//   loops over all n tokens, where the TPU kernel's sequential grid did;
//   the hidden tile is recomputed from x and rstd, the cotangent tile
//   un-rotated, as they are loaded.
// Ragged n and d are masked at every edge (loads read zeros, stores are
// skipped); the projection widths are whole heads. GQA and MQA only narrow
// wk and wv.
//
// bf16 on the tensor cores (the training path), all three kernels on
// tc_tile.cuh's mainloop (wgmma fed by a TMA ring, 128 x 256 tiles). TMA
// cannot norm or un-rotate a tile as it loads it, but both are elementwise,
// so a pass writes each transformed operand once to a bf16 scratch, rounded
// at exactly the points where Hidden and Cotangent round: the products see
// bit for bit the operands the SIMT kernels see.
// - prologue_norm_kernel writes the normed hidden [n, d] (one warp per
//   token, the fp64 row statistic as prologue_rstd_kernel takes it);
//   prologue_unrope_kernel writes unrope(dq) | unrope(dk) [n, (hq + hkv) hd]
//   (16-byte loads and stores, 8 columns a thread).
// - forward: prologue_fwd_tc_kernel, one launch over the row tiles of the
//   tokens x the column tiles of q | k | v together (each block picks its
//   W's tensor map and its output: 768 blocks at LLaMA-7B width, 5.8 waves
//   on 132 SMs); A the normed hidden (K-major), B W[f, col] (MN-major). The
//   RoPE epilogue pairs accumulator registers of one thread (RopeStore).
// - dhidden: prologue_dhidden_tc_kernel once per projection: A the scratch's
//   q columns, its k columns, then dv, each K-major [n, width]; B wq, wk, wv
//   as [d, width], K-major. The first launch writes the fp32 dhidden, the
//   next two add to it (tc::DhStore).
// - dW: prologue_dw_tc_kernel, one launch over the feature tiles x the
//   column tiles of dwq | dwk | dwv (1,536 blocks at LLaMA-7B width), each
//   over all n tokens (32 steps of 64 at n 2048; TMA reads zeros past a
//   ragged n); A(f, t) the normed hidden, B(j, t) the un-rotated scratch's
//   columns (or dv), both MN-major; a bf16 store (tc::BfStore).
// The scratches live for the call only (the wrapper allocates them): the
// backward recomputes the normed hidden rather than keeping it. The route
// needs d a multiple of 8 and 16-byte aligned operands; the wrapper picks it
// by dtype and width. fp32 (wgmma on fp32 would be TF32) and bf16 off that
// grid stay on the SIMT kernels.
//
// What bounds these kernels on the card: each is 2 n d (hq + 2 hkv) hd
// operations (0.21 TFLOP at n 2048, d 4096, 32 + 2 x 32 heads of 128) over
// ~0.17-0.19 GB, so the bound is the tensor-core rate (0.21 ms), not the
// memory (<= 0.06 ms). The SIMT kernels do the products with scalar fp32
// FMAs and are held to 128 registers a thread (two blocks per SM); the
// tensor-core route adds to the products at the wgmma rate its memory-bound
// passes: the norm (32 MiB moved, ~0.01 ms at 3.35 TB/s) and the
// un-rotation (64 MiB, ~0.02 ms).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.
// Each entry point returns a cudaError_t (0 = launched); it launches on the
// stream it is given and neither allocates nor synchronises.

#include <math.h>

#include "simt_tile.cuh"
#include "tc_tile.cuh"

namespace {

using namespace lpt;

constexpr int HD = 128;  // the head_dim the kernels take: one head per column tile
constexpr int HALF = HD / 2;
static_assert(HD == TILE && HALF == 64, "a column tile is one head; micro() pairs j, j + 64");

// The normed hidden round(nw[f] * (x[t, f] * rstd[t])) as an operand: rows
// are tokens (TOKEN_ROWS) or features, the depth the other.
template <typename T, bool TOKEN_ROWS>
struct Hidden {
  static constexpr bool kContig = TOKEN_ROWS;  // x is contiguous along the features
  const T* __restrict__ x;
  const float* __restrict__ nw;
  const float* __restrict__ rstd;
  size_t d;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int t = TOKEN_ROWS ? r : k, f = TOKEN_ROWS ? k : r;
    return round_to<T>(nw[f] * (to_f32(x[(size_t)t * d + f]) * rstd[t]));
  }
};

// A cotangent y [n, width] (columns from one head-aligned base) as an
// operand, un-rotated when `rope`: unrope(y)[j] = round(round(y[j] cos[j]) +
// rt[j]). Rows are tokens (TOKEN_ROWS) or columns, the depth the other.
template <typename T, bool TOKEN_ROWS>
struct Cotangent {
  static constexpr bool kContig = TOKEN_ROWS;  // y is contiguous along the columns
  const T* __restrict__ y;
  const T* __restrict__ cos;
  const T* __restrict__ sin;
  size_t width;
  bool rope;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int t = TOKEN_ROWS ? r : k, c = TOKEN_ROWS ? k : r;
    const T* row = y + (size_t)t * width;
    const float v = to_f32(row[c]);
    if (!rope) return v;
    const int j = c % HD;
    const bool low = j < HALF;
    const int pj = low ? j + HALF : j - HALF;  // the partner column in the head
    const float yc = round_to<T>(v * to_f32(cos[(size_t)t * HD + j]));
    const float ys = round_to<T>(to_f32(row[c - j + pj]) * to_f32(sin[(size_t)t * HD + pj]));
    return round_to<T>(low ? yc + ys : yc - ys);
  }
};

// The column tile `tile` of the concatenated q | k | v width: which tensor,
// its width, the tile's first column and whether RoPE applies.
template <typename P>
struct HeadTile {
  P q, k, v;
  __device__ __forceinline__ void select(int tile, int hq, int hkv, P& p, int& width, int& col0,
                                         bool& rope) const {
    if (tile < hq) {
      p = q, width = hq * HD, col0 = tile * HD, rope = true;
    } else if (tile < hq + hkv) {
      p = k, width = hkv * HD, col0 = (tile - hq) * HD, rope = true;
    } else {
      p = v, width = hkv * HD, col0 = (tile - hq - hkv) * HD, rope = false;
    }
  }
};

// rstd[t] = 1 / sqrt(mean_f x[t, f]^2 + eps) in fp64, rounded to fp32; one
// warp per token.
template <typename T>
__global__ void __launch_bounds__(NT)
prologue_rstd_kernel(const T* __restrict__ x, float* __restrict__ rstd, int n, int d,
                     double eps) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  double s = 0.0;
  if (t < n)
    for (int f = lane; f < d; f += 32) {
      const double v = to_f32(x[(size_t)t * d + f]);
      s += v * v;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (t < n && lane == 0) rstd[t] = (float)(1.0 / sqrt(s / d + eps));
}

// Forward: one block per (token tile blockIdx.y) x (head blockIdx.x of q | k | v).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
prologue_fwd_kernel(const T* __restrict__ x, const float* __restrict__ nw,
                    const float* __restrict__ rstd, HeadTile<const T*> w, const T* __restrict__ cos,
                    const T* __restrict__ sin, HeadTile<T*> out, int n, int d, int hq, int hkv) {
  __shared__ __align__(16) TileSmem smem;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE;
  const T* wp;
  T* op;
  int width, col0;
  bool rope;
  w.select(blockIdx.x, hq, hkv, wp, width, col0, rope);
  out.select(blockIdx.x, hq, hkv, op, width, col0, rope);
  float acc[8][8];
  zero(acc);
  // A(t, f) = hidden[t, f]; B(j, f) = W[f, col0 + j]
  tile_product(acc, smem, Hidden<T, true>{x, nw, rstd, (size_t)d},
               Dense<T, false>{wp + col0, (size_t)width}, m0, 0, n, HD, d);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = m0 + micro(ty, r);
    if (t >= n) continue;
    T* row = op + (size_t)t * width + col0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // columns j and j + HALF: micro(tx, c + 4) == j + HALF
      const int j = micro(tx, c);
      const float p1 = round_to<T>(acc[r][c]), p2 = round_to<T>(acc[r][c + 4]);
      float o1 = p1, o2 = p2;
      if (rope) {
        const T* cs = cos + (size_t)t * HD;
        const T* sn = sin + (size_t)t * HD;
        o1 = round_to<T>(p1 * to_f32(cs[j])) + round_to<T>(-p2 * to_f32(sn[j]));
        o2 = round_to<T>(p2 * to_f32(cs[j + HALF])) + round_to<T>(p1 * to_f32(sn[j + HALF]));
      }
      row[j] = from_f32<T>(o1);
      row[j + HALF] = from_f32<T>(o2);
    }
  }
}

// dhidden: one block per (token tile blockIdx.y) x (feature tile blockIdx.x).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
prologue_dhidden_kernel(HeadTile<const T*> dy, HeadTile<const T*> w, const T* __restrict__ cos,
                        const T* __restrict__ sin, float* __restrict__ dh, int n, int d, int hq,
                        int hkv) {
  __shared__ __align__(16) TileSmem smem;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[8][8];
  zero(acc);
  // over the heads of q, then k, then v: A(t, c) = unrope(dy)[t, c]; B(f, c) = W[f, c]
  const int widths[3] = {hq * HD, hkv * HD, hkv * HD};
  const T* dys[3] = {dy.q, dy.k, dy.v};
  const T* ws[3] = {w.q, w.k, w.v};
  for (int i = 0; i < 3; ++i)
    tile_product(acc, smem, Cotangent<T, true>{dys[i], cos, sin, (size_t)widths[i], i < 2},
                 Dense<T, true>{ws[i], (size_t)widths[i]}, m0, n0, n, d, widths[i]);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = m0 + micro(ty, r);
    if (t >= n) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int f = n0 + micro(tx, c);
      if (f < d) dh[(size_t)t * d + f] = acc[r][c];
    }
  }
}

// dW: one block per (feature tile blockIdx.y) x (head blockIdx.x of dwq | dwk | dwv),
// looping over all n tokens.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
prologue_dw_kernel(const T* __restrict__ x, const float* __restrict__ nw,
                   const float* __restrict__ rstd, HeadTile<const T*> dy, const T* __restrict__ cos,
                   const T* __restrict__ sin, HeadTile<T*> dw, int n, int d, int hq, int hkv) {
  __shared__ __align__(16) TileSmem smem;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE;
  const T* yp;
  T* op;
  int width, col0;
  bool rope;
  dy.select(blockIdx.x, hq, hkv, yp, width, col0, rope);
  dw.select(blockIdx.x, hq, hkv, op, width, col0, rope);
  float acc[8][8];
  zero(acc);
  // A(f, t) = hidden[t, f]; B(j, t) = unrope(dy)[t, col0 + j]
  tile_product(acc, smem, Hidden<T, false>{x, nw, rstd, (size_t)d},
               Cotangent<T, false>{yp + col0, cos, sin, (size_t)width, rope}, m0, 0, d, HD, n);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int f = m0 + micro(ty, r);
    if (f >= d) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) op[(size_t)f * width + col0 + micro(tx, c)] = from_f32<T>(acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// The bf16 passes on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;  // bf16 columns of one 16-byte vector

// hidden [n, d] = round(nw[f] * (x[t, f] * rstd[t])) with rstd as
// prologue_rstd_kernel takes it (fp64 sum of squares, rounded to fp32 once):
// the operand Hidden forms as it loads, rounded at the same point, written
// once for the products to read by TMA. One warp per token, 8 features (16
// bytes) a lane; d a multiple of 8. The row is read twice (the second time
// from L1 / L2).
__global__ void __launch_bounds__(NT)
prologue_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
                     bf16* __restrict__ hidden, int n, int d, double eps) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (t >= n) return;  // the whole warp: t is the warp's
  const bf16* xr = x + (size_t)t * d;
  double s = 0.0;
  for (int f = VEC * lane; f < d; f += VEC * 32) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + f);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const double v = to_f32(xe[e]);
      s += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float rstd = (float)(1.0 / sqrt(s / d + eps));
  bf16* hr = hidden + (size_t)t * d;
  for (int f = VEC * lane; f < d; f += VEC * 32) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xr + f);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    const float4 w0 = *reinterpret_cast<const float4*>(nw + f);
    const float4 w1 = *reinterpret_cast<const float4*>(nw + f + 4);
    const float w[VEC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    uint4 hv;
    bf16* he = reinterpret_cast<bf16*>(&hv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) he[e] = from_f32<bf16>(w[e] * (to_f32(xe[e]) * rstd));
    *reinterpret_cast<uint4*>(hr + f) = hv;
  }
}

// out [n, (hq + hkv) hd] = unrope(dq) | unrope(dk), rounded as Cotangent
// rounds: round(round(y[j] cos[j]) +- round(y[pj] sin[pj])), pj = j -+ 64 in
// the same head. One thread per 8 columns; a vector never straddles a head
// or the two halves of one (HALF is a multiple of VEC).
__global__ void __launch_bounds__(NT)
prologue_unrope_kernel(const bf16* __restrict__ dq, const bf16* __restrict__ dk,
                       const bf16* __restrict__ cos, const bf16* __restrict__ sin,
                       bf16* __restrict__ out, int n, int hq, int hkv) {
  const int width_q = hq * HD, width = (hq + hkv) * HD, vecs = width / VEC;
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= (size_t)n * vecs) return;
  const int t = (int)(i / vecs), c = (int)(i % vecs) * VEC;
  const bf16* y = c < width_q ? dq + (size_t)t * width_q + c
                              : dk + (size_t)t * (hkv * HD) + (c - width_q);
  const int j = c % HD;
  const bool low = j < HALF;
  const int pj = low ? j + HALF : j - HALF;
  const uint4 yv = *reinterpret_cast<const uint4*>(y);
  const uint4 pv = *reinterpret_cast<const uint4*>(y - j + pj);
  const uint4 cv = *reinterpret_cast<const uint4*>(cos + (size_t)t * HD + j);
  const uint4 sv = *reinterpret_cast<const uint4*>(sin + (size_t)t * HD + pj);
  const bf16* ye = reinterpret_cast<const bf16*>(&yv);
  const bf16* pe = reinterpret_cast<const bf16*>(&pv);
  const bf16* ce = reinterpret_cast<const bf16*>(&cv);
  const bf16* se = reinterpret_cast<const bf16*>(&sv);
  uint4 ov;
  bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float yc = round_to<bf16>(to_f32(ye[e]) * to_f32(ce[e]));
    const float ys = round_to<bf16>(to_f32(pe[e]) * to_f32(se[e]));
    oe[e] = from_f32<bf16>(low ? yc + ys : yc - ys);
  }
  *reinterpret_cast<uint4*>(out + (size_t)t * width + c) = ov;
}

// dhidden (+)= A W^T for one projection: A [n, width] (K-major: a column
// slice of the un-rotated scratch, or dv), B(f, c) = W[f, c] (K-major).
__global__ void __launch_bounds__(tc::THREADS, 1)
prologue_dhidden_tc_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap w_map, int n, int d, int width,
                           tc::DhStore out) {
  tc::tile_product<false, false>(a_map, w_map, n, d, width, out);
}

// The column tiles of the concatenated q | k | v products, each projection's
// tiles starting at its own column 0 (no tile straddles two projections):
// returns the projection (0 q, 1 k, 2 v) of column tile `tile` and sets n0,
// the tile's first column in it.
__device__ __forceinline__ int projection_tile(int tile, int hq, int hkv, int& n0) {
  const int tq = tc::cdiv(hq * HD, tc::BN), tkv = tc::cdiv(hkv * HD, tc::BN);
  const int p = tile < tq ? 0 : tile < tq + tkv ? 1 : 2;
  n0 = (tile - (p == 0 ? 0 : p == 1 ? tq : tq + tkv)) * tc::BN;
  return p;
}

inline int projection_tiles(int hq, int hkv) {
  return tc::cdiv(hq * HD, tc::BN) + 2 * tc::cdiv(hkv * HD, tc::BN);
}

// q or k [n, width] = rope(round(acc)), as prologue_fwd_kernel's epilogue
// rounds it: o1 = round(p1 cos[j]) + round(-p2 sin[j]), o2 = round(p2 cos[j
// + 64]) + round(p1 sin[j + 64]), the sum rounded on the store; v (rope 0)
// only rounded. The tile starts on a multiple of BN = 2 HD columns, so it is
// two whole heads, and the thread's d[4j + 2h + e] is column 8j + 2(t % 4) +
// e: in head j / 16 at 8(j % 16) + 2(t % 4) + e, whose rotate_half partner 64
// columns on is d[4(j + 8) + 2h + e] of the same thread for j % 16 < 8. No
// exchange between threads. A head past the width (k, v of one head) is
// never stored.
struct RopeStore {
  bf16* __restrict__ out;
  const bf16* __restrict__ cos;
  const bf16* __restrict__ sin;
  int n, width, rope;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
    static_assert(NA == 4 * 2 * HD / 8, "a tile is two heads wide");
    if (!rope) {
      tc::BfStore{out, n, width, 0, width}(acc, row, col);
      return;
    }
    const int lo = col % HD;  // 2 (t % 4): the thread's first column in a head
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= n) continue;
      const bf16* cs = cos + (size_t)r * HD + lo;
      const bf16* sn = sin + (size_t)r * HD + lo;
      bf16* o = out + (size_t)r * width + col;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // the low half's column pairs 8j + lo, + 1
        const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cs + 8 * j));
        const float2 c2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cs + 8 * j + HALF));
        const float2 s1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sn + 8 * j));
        const float2 s2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sn + 8 * j + HALF));
#pragma unroll
        for (int head = 0; head < 2; ++head) {
          const int jj = j + 16 * head;
          if (col + 8 * jj >= width) continue;  // the whole head lies past the width
          const int i1 = 4 * jj + 2 * h, i2 = i1 + 32;  // columns c and c + 64
          const float p1x = round_to<bf16>(acc[i1]), p1y = round_to<bf16>(acc[i1 + 1]);
          const float p2x = round_to<bf16>(acc[i2]), p2y = round_to<bf16>(acc[i2 + 1]);
          const float o1x = round_to<bf16>(p1x * c1.x) + round_to<bf16>(-p2x * s1.x);
          const float o1y = round_to<bf16>(p1y * c1.y) + round_to<bf16>(-p2y * s1.y);
          const float o2x = round_to<bf16>(p2x * c2.x) + round_to<bf16>(p1x * s2.x);
          const float o2y = round_to<bf16>(p2y * c2.y) + round_to<bf16>(p1y * s2.y);
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj) = __floats2bfloat162_rn(o1x, o1y);
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj + HALF) = __floats2bfloat162_rn(o2x, o2y);
        }
      }
    }
  }
};

// q | k | v: A = the normed hidden [n, d] (K-major), B(j, f) = W[f, n0 + j]
// (MN-major) of the block's projection; a block per (token tile blockIdx.x)
// x (column tile blockIdx.y of the concatenated q | k | v).
__global__ void __launch_bounds__(tc::THREADS, 1)
prologue_fwd_tc_kernel(const __grid_constant__ CUtensorMap h_map,
                       const __grid_constant__ CUtensorMap wq_map,
                       const __grid_constant__ CUtensorMap wk_map,
                       const __grid_constant__ CUtensorMap wv_map, HeadTile<bf16*> out,
                       const bf16* __restrict__ cos, const bf16* __restrict__ sin, int n, int d,
                       int hq, int hkv) {
  int n0;
  const int p = projection_tile(blockIdx.y, hq, hkv, n0);
  const int width = (p == 0 ? hq : hkv) * HD;
  tc::tile_product_at<false, true>(
      h_map, p == 0 ? wq_map : p == 1 ? wk_map : wv_map, blockIdx.x * tc::BM, n0, n, width, d,
      RopeStore{p == 0 ? out.q : p == 1 ? out.k : out.v, cos, sin, n, width, p < 2});
}

// dwq | dwk | dwv [d, width] in bf16: A(f, t) = hidden[t, f] (MN-major), B(j,
// t) = the block's cotangent (un-rotated for q and k) at [t, n0 + j]
// (MN-major); a block per (feature tile blockIdx.x) x (column tile
// blockIdx.y), over all n tokens.
__global__ void __launch_bounds__(tc::THREADS, 1)
prologue_dw_tc_kernel(const __grid_constant__ CUtensorMap h_map,
                      const __grid_constant__ CUtensorMap dq_map,
                      const __grid_constant__ CUtensorMap dk_map,
                      const __grid_constant__ CUtensorMap dv_map, HeadTile<bf16*> dw, int n, int d,
                      int hq, int hkv) {
  int n0;
  const int p = projection_tile(blockIdx.y, hq, hkv, n0);
  const int width = (p == 0 ? hq : hkv) * HD;
  tc::tile_product_at<true, true>(h_map, p == 0 ? dq_map : p == 1 ? dk_map : dv_map,
                                  blockIdx.x * tc::BM, n0, d, width, n,
                                  tc::BfStore{p == 0 ? dw.q : p == 1 ? dw.k : dw.v, d, width, 0,
                                              width});
}

cudaError_t launch_norm(const void* x, const float* nw, void* hidden, int n, int d, double eps,
                        cudaStream_t stream) {
  prologue_norm_kernel<<<cdiv(n, NT / 32), NT, 0, stream>>>(
      static_cast<const bf16*>(x), nw, static_cast<bf16*>(hidden), n, d, eps);
  return cudaGetLastError();
}

// unrope(dq) | unrope(dk) into the scratch [n, (hq + hkv) hd].
cudaError_t launch_unrope(const void* dq, const void* dk, const void* cos, const void* sin,
                          bf16* scr, int n, int hq, int hkv, cudaStream_t stream) {
  const size_t vecs = (size_t)n * ((hq + hkv) * HD / VEC);
  prologue_unrope_kernel<<<(unsigned)((vecs + NT - 1) / NT), NT, 0, stream>>>(
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk), static_cast<const bf16*>(cos),
      static_cast<const bf16*>(sin), scr, n, hq, hkv);
  return cudaGetLastError();
}

cudaError_t launch_fwd_tc(const void* x, const float* nw, const void* wq, const void* wk,
                          const void* wv, const void* cos, const void* sin, void* hidden, void* q,
                          void* k, void* v, int n, int d, int hq, int hkv, double eps,
                          cudaStream_t stream) {
  const int width_q = hq * HD, width_kv = hkv * HD;
  cudaError_t err = launch_norm(x, nw, hidden, n, d, eps, stream);
  CUtensorMap h_map, wq_map, wk_map, wv_map;
  if (err == cudaSuccess) err = tc::make_map(&h_map, hidden, d, n, d);
  if (err == cudaSuccess) err = tc::make_map(&wq_map, wq, width_q, d, width_q);
  if (err == cudaSuccess) err = tc::make_map(&wk_map, wk, width_kv, d, width_kv);
  if (err == cudaSuccess) err = tc::make_map(&wv_map, wv, width_kv, d, width_kv);
  if (err != cudaSuccess) return err;
  return tc::launch_tiles(prologue_fwd_tc_kernel, tc::cdiv(n, tc::BM), projection_tiles(hq, hkv),
                          stream, h_map, wq_map, wk_map, wv_map,
                          HeadTile<bf16*>{static_cast<bf16*>(q), static_cast<bf16*>(k),
                                          static_cast<bf16*>(v)},
                          static_cast<const bf16*>(cos), static_cast<const bf16*>(sin), n, d, hq,
                          hkv);
}

cudaError_t launch_dw_tc(const void* x, const float* nw, const void* dq, const void* dk,
                         const void* dv, const void* cos, const void* sin, void* hidden,
                         void* scratch, void* dwq, void* dwk, void* dwv, int n, int d, int hq,
                         int hkv, double eps, cudaStream_t stream) {
  const int width_q = hq * HD, width_kv = hkv * HD, width = width_q + width_kv;
  bf16* scr = static_cast<bf16*>(scratch);
  cudaError_t err = launch_norm(x, nw, hidden, n, d, eps, stream);
  if (err == cudaSuccess) err = launch_unrope(dq, dk, cos, sin, scr, n, hq, hkv, stream);
  CUtensorMap h_map, dq_map, dk_map, dv_map;
  if (err == cudaSuccess) err = tc::make_map(&h_map, hidden, d, n, d);
  if (err == cudaSuccess) err = tc::make_map(&dq_map, scr, width_q, n, width);
  if (err == cudaSuccess) err = tc::make_map(&dk_map, scr + width_q, width_kv, n, width);
  if (err == cudaSuccess) err = tc::make_map(&dv_map, dv, width_kv, n, width_kv);
  if (err != cudaSuccess) return err;
  return tc::launch_tiles(prologue_dw_tc_kernel, tc::cdiv(d, tc::BM), projection_tiles(hq, hkv),
                          stream, h_map, dq_map, dk_map, dv_map,
                          HeadTile<bf16*>{static_cast<bf16*>(dwq), static_cast<bf16*>(dwk),
                                          static_cast<bf16*>(dwv)},
                          n, d, hq, hkv);
}

cudaError_t launch_dhidden_tc(const void* dq, const void* dk, const void* dv, const void* wq,
                              const void* wk, const void* wv, const void* cos, const void* sin,
                              void* scratch, float* dh, int n, int d, int hq, int hkv,
                              cudaStream_t stream) {
  const int width_q = hq * HD, width_kv = hkv * HD, width = width_q + width_kv;
  bf16* scr = static_cast<bf16*>(scratch);
  cudaError_t err = launch_unrope(dq, dk, cos, sin, scr, n, hq, hkv, stream);
  // the three products: (scratch q columns, wq), (scratch k columns, wk), (dv, wv)
  const void* as[3] = {scr, scr + width_q, dv};
  const size_t lds[3] = {(size_t)width, (size_t)width, (size_t)width_kv};
  const void* ws[3] = {wq, wk, wv};
  const int widths[3] = {width_q, width_kv, width_kv};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    CUtensorMap a_map, w_map;
    err = tc::make_map(&a_map, as[i], widths[i], n, lds[i]);
    if (err == cudaSuccess) err = tc::make_map(&w_map, ws[i], widths[i], d, widths[i]);
    if (err == cudaSuccess)
      err = tc::launch(prologue_dhidden_tc_kernel, n, d, stream, a_map, w_map, n, d, widths[i],
                       tc::DhStore{dh, n, d, i > 0});
  }
  return err;
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_rstd(const void* x, float* rstd, int n, int d, double eps, cudaStream_t stream) {
  prologue_rstd_kernel<T><<<cdiv(n, NT / 32), NT, 0, stream>>>(static_cast<const T*>(x), rstd, n,
                                                                 d, eps);
  return cudaGetLastError();
}

template <typename T>
HeadTile<const T*> tiles(const void* q, const void* k, const void* v) {
  return {static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v)};
}

template <typename T>
HeadTile<T*> out_tiles(void* q, void* k, void* v) {
  return {static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v)};
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* nw, float* rstd, const void* wq, const void* wk,
                       const void* wv, const void* cos, const void* sin, void* q, void* k, void* v,
                       int n, int d, int hq, int hkv, double eps, cudaStream_t stream) {
  cudaError_t err = launch_rstd<T>(x, rstd, n, d, eps, stream);
  if (err != cudaSuccess) return err;
  prologue_fwd_kernel<T><<<dim3(hq + 2 * hkv, cdiv(n, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(x), nw, rstd, tiles<T>(wq, wk, wv), static_cast<const T*>(cos),
      static_cast<const T*>(sin), out_tiles<T>(q, k, v), n, d, hq, hkv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dhidden(const void* dq, const void* dk, const void* dv, const void* wq,
                           const void* wk, const void* wv, const void* cos, const void* sin,
                           float* dh, int n, int d, int hq, int hkv, cudaStream_t stream) {
  prologue_dhidden_kernel<T><<<dim3(cdiv(d, TILE), cdiv(n, TILE)), NT, 0, stream>>>(
      tiles<T>(dq, dk, dv), tiles<T>(wq, wk, wv), static_cast<const T*>(cos),
      static_cast<const T*>(sin), dh, n, d, hq, hkv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const float* nw, float* rstd, const void* dq, const void* dk,
                      const void* dv, const void* cos, const void* sin, void* dwq, void* dwk,
                      void* dwv, int n, int d, int hq, int hkv, double eps, cudaStream_t stream) {
  cudaError_t err = launch_rstd<T>(x, rstd, n, d, eps, stream);
  if (err != cudaSuccess) return err;
  prologue_dw_kernel<T><<<dim3(hq + 2 * hkv, cdiv(d, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(x), nw, rstd, tiles<T>(dq, dk, dv), static_cast<const T*>(cos),
      static_cast<const T*>(sin), out_tiles<T>(dwq, dwk, dwv), n, d, hq, hkv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The head_dim the kernels take.
int lpt_prologue_head_dim() { return HD; }

// x [n, d], nw fp32 [d], rstd fp32 [n] (scratch), wq [d, hq hd], wk and wv
// [d, hkv hd], cos and sin [n, hd] -> q [n, hq hd], k and v [n, hkv hd].
int lpt_prologue_fwd(const void* x, const float* nw, float* rstd, const void* wq, const void* wk,
                     const void* wv, const void* cos, const void* sin, void* q, void* k, void* v,
                     int n, int d, int hq, int hkv, double eps, int dtype, void* stream) {
#define CALL(T)                                                                              \
  launch_fwd<T>(x, nw, rstd, wq, wk, wv, cos, sin, q, k, v, n, d, hq, hkv, eps,             \
                static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

// dq [n, hq hd], dk and dv [n, hkv hd], the weights and cos, sin as above
// -> dh fp32 [n, d].
int lpt_prologue_dhidden(const void* dq, const void* dk, const void* dv, const void* wq,
                         const void* wk, const void* wv, const void* cos, const void* sin,
                         float* dh, int n, int d, int hq, int hkv, int dtype, void* stream) {
#define CALL(T)                                                                              \
  launch_dhidden<T>(dq, dk, dv, wq, wk, wv, cos, sin, dh, n, d, hq, hkv,                     \
                    static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

// The bf16 dhidden on the tensor cores: lpt_prologue_dhidden's arguments
// without the dtype, with a bf16 scratch [n, (hq + hkv) hd]; d a multiple of
// 8, every pointer 16-byte aligned.
int lpt_prologue_dhidden_tc(const void* dq, const void* dk, const void* dv, const void* wq,
                            const void* wk, const void* wv, const void* cos, const void* sin,
                            void* scratch, float* dh, int n, int d, int hq, int hkv,
                            void* stream) {
  return launch_dhidden_tc(dq, dk, dv, wq, wk, wv, cos, sin, scratch, dh, n, d, hq, hkv,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 forward on the tensor cores: lpt_prologue_fwd's arguments
// without rstd and the dtype, with a bf16 scratch hidden [n, d]; d a
// multiple of 8, every pointer 16-byte aligned.
int lpt_prologue_fwd_tc(const void* x, const float* nw, const void* wq, const void* wk,
                        const void* wv, const void* cos, const void* sin, void* hidden, void* q,
                        void* k, void* v, int n, int d, int hq, int hkv, double eps,
                        void* stream) {
  return launch_fwd_tc(x, nw, wq, wk, wv, cos, sin, hidden, q, k, v, n, d, hq, hkv, eps,
                       static_cast<cudaStream_t>(stream));
}

// x, nw, rstd (scratch), dq, dk, dv, cos, sin as above -> dwq [d, hq hd],
// dwk and dwv [d, hkv hd], in x's dtype.
int lpt_prologue_dw(const void* x, const float* nw, float* rstd, const void* dq, const void* dk,
                    const void* dv, const void* cos, const void* sin, void* dwq, void* dwk,
                    void* dwv, int n, int d, int hq, int hkv, double eps, int dtype, void* stream) {
#define CALL(T)                                                                              \
  launch_dw<T>(x, nw, rstd, dq, dk, dv, cos, sin, dwq, dwk, dwv, n, d, hq, hkv, eps,        \
               static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

// The bf16 dW on the tensor cores: lpt_prologue_dw's arguments without rstd
// and the dtype, with the bf16 scratches hidden [n, d] and [n, (hq + hkv)
// hd]; d a multiple of 8, every pointer 16-byte aligned.
int lpt_prologue_dw_tc(const void* x, const float* nw, const void* dq, const void* dk,
                       const void* dv, const void* cos, const void* sin, void* hidden,
                       void* scratch, void* dwq, void* dwk, void* dwv, int n, int d, int hq,
                       int hkv, double eps, void* stream) {
  return launch_dw_tc(x, nw, dq, dk, dv, cos, sin, hidden, scratch, dwq, dwk, dwv, n, d, hq, hkv,
                      eps, static_cast<cudaStream_t>(stream));
}

const char* lpt_prologue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
