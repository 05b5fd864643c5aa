// Fused RMSNorm -> QKV -> RoPE prologue for Hopper: forward, dhidden and dW.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/pallas_prologue.py:
//   prologue_rstd_kernel + prologue_fwd_kernel  <- _fwd_kernel (pallas_call in _fwd)
//   prologue_dhidden_kernel                     <- _dhidden_kernel (first pallas_call in _bwd)
//     in bf16 on the tensor cores: prologue_unrope_kernel + prologue_dhidden_tc_kernel
//   prologue_rstd_kernel + prologue_dw_kernel   <- _dw_kernel (second pallas_call in _bwd)
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
// The normed hidden and the pre-RoPE q, k and their cotangents never reach
// device memory: each is formed from x (or dq, dk) as its tile is loaded.
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
// bf16 dhidden on the tensor cores (the training path): TMA cannot
// un-rotate a tile as it loads it, but the un-rotation is elementwise, so
// prologue_unrope_kernel first writes unrope(dq) | unrope(dk) into a bf16
// scratch [n, (hq + hkv) hd] (16-byte loads and stores, 8 columns a thread,
// rounding at exactly Cotangent's points: the products see the operands the
// SIMT kernel sees). Then prologue_dhidden_tc_kernel runs once per
// projection on tc_tile.cuh's mainloop (wgmma fed by a TMA ring, 128 x 256
// tiles): A the scratch's q columns, its k columns, then dv, each K-major
// [n, width]; B wq, wk, wv as [d, width], K-major. The first launch writes
// the fp32 dhidden, the next two add to it (tc::DhStore). It needs d a
// multiple of 8 and 16-byte aligned operands; the wrapper picks the route by
// dtype and width. fp32 (wgmma on fp32 would be TF32) and bf16 off that grid
// stay on prologue_dhidden_kernel.
//
// What bounds these kernels on the card: each is 2 n d (hq + 2 hkv) hd
// operations (0.21 TFLOP at n 2048, d 4096, 32 + 2 x 32 heads of 128) over
// ~0.17-0.19 GB, so the bound is the tensor-core rate (0.21 ms), not the
// memory (<= 0.06 ms). The SIMT kernels do the products with scalar fp32
// FMAs and are held to 128 registers a thread (two blocks per SM); the
// tensor-core dhidden adds the un-rotation pass (memory-bound: 64 MiB moved,
// ~0.02 ms at 3.35 TB/s) to three products at the wgmma rate.
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
// dhidden on the tensor cores (bf16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;  // bf16 columns of one 16-byte vector

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

cudaError_t launch_dhidden_tc(const void* dq, const void* dk, const void* dv, const void* wq,
                              const void* wk, const void* wv, const void* cos, const void* sin,
                              void* scratch, float* dh, int n, int d, int hq, int hkv,
                              cudaStream_t stream) {
  const int width_q = hq * HD, width_kv = hkv * HD, width = width_q + width_kv;
  const size_t vecs = (size_t)n * (width / VEC);
  bf16* scr = static_cast<bf16*>(scratch);
  prologue_unrope_kernel<<<(unsigned)((vecs + NT - 1) / NT), NT, 0, stream>>>(
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk), static_cast<const bf16*>(cos),
      static_cast<const bf16*>(sin), scr, n, hq, hkv);
  cudaError_t err = cudaGetLastError();
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

const char* lpt_prologue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
