// Fused lm-head + cross-entropy for Hopper: forward statistics, dh and dW.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/pallas_ce.py:
//   ce_stats_kernel + ce_lse_kernel  <- _fwd_kernel (pallas_call in _fwd_stats)
//   ce_grad_kernel  + ce_dh_kernel   <- _dh_kernel  (first pallas_call in _backward)
//   ce_grad_kernel  + ce_dw_kernel   <- _dw_kernel  (second pallas_call in _backward)
//   in bf16 on the tensor cores: ce_stats_tc_kernel + ce_lse_kernel,
//   ce_grad_tc_kernel + ce_dh_tc_kernel and ce_grad_tc_kernel +
//   ce_dw_tc_kernel, for the same three.
//
// What they compute is the TPU kernels' contract, not their block structure.
// With h [n, d], W [d, V], targets t [n] (already made safe: 0 where ignored)
// and logits l = h W in fp32:
//   forward: lse[i] = log sum_j exp(l[i, j]), tgt[i] = l[i, t[i]] (0 when t[i]
//            is outside [0, V));
//   g      = ((exp(l - lse) - onehot(t)) * s) rounded to the compute dtype,
//            s[i] = valid[i] * (the loss sum's cotangent);
//   dh     = g W^T (fp32 out), dW = h^T g (out in W's dtype).
// The logits never reach device memory.
//
// Why not the TPU's blocks. The TPU kernels keep a [bn, d] fp32 dh and a
// [d, V / chunks] fp32 dW accumulator in VMEM across a sequential grid axis;
// at d = 4096 one 64-row dh block is 1 MB, far over the 227 KB of shared
// memory a Hopper block has, and blocks run in no order. So here:
// - forward: one block per (token, vocab) tile (128 x 128 on the SIMT
//   route, 128 x 256 on the tensor cores) computes its logits and reduces
//   each row to a partial (max, sum of exps) and, for the one tile that holds
//   the row's target column, the target logit; a second small kernel merges
//   the partials of a row with the online-lse rule,
//   lse = M + log sum_j z_j exp(m_j - M). The grid covers the whole vocab
//   (2000 tensor-core blocks at n 2048, V 32000), not one block per token
//   block (16).
// - backward, per vocab chunk [c0, c0 + vc) of `loss_vocab_chunks`:
//   ce_grad_kernel recomputes the chunk's logits once and writes g to an
//   [n, vc] scratch in the compute dtype; ce_dh_kernel adds g W_c^T into an
//   fp32 [n, d] dh (the first chunk writes it); ce_dw_kernel writes
//   dW_c = h^T g. When both gradients are wanted the pair shares one
//   recompute: 3 products of 2 n d vc operations per chunk, where the TPU's
//   two kernels do 4. Each output element has one writer: no atomics.
// A vocab, chunk, token count or width that is not a multiple of the tiles
// is masked at the ragged edge (loads read zeros, stores are skipped).
//
// What bounds these kernels on the card: every pass is a GEMM-sized product
// (2 n d V operations; 0.54 TFLOP at n 2048, d 4096, V 32000) over far fewer
// bytes, so the bound is the tensor-core rate: 1.09 ms for dh or dW alone
// (recompute + product) and 1.63 ms for the pair at that shape, at 989
// TFLOP/s bf16.
// - bf16 (the training path): ce_stats_tc_kernel (forward), and
//   ce_grad_tc_kernel, ce_dh_tc_kernel and ce_dw_tc_kernel (backward) run
//   their products on the tensor cores, on the mainloop of tc_tile.cuh (wgmma
//   m64nNk16, bf16 in, fp32 accumulate; TMA boxes through a 4-stage mbarrier
//   ring; one producer and two consumer warpgroups; 128 x 256 block tiles).
//   Each takes its operands in the order they lie in memory (wgmma's
//   transpose flags); each tensor map covers the whole vocab (forward) or the
//   vocab chunk (backward), so TMA reads zeros past its edge. They need what
//   TMA can address: d and V (forward) or d and vc (backward) multiples of 8
//   (16-byte row strides, a 16-byte aligned W + c0); the wrapper picks the
//   route by dtype and shape, separately for the forward and the backward.
// - fp32 and bf16 off that grid: scalar fp32 FMAs on the tiled
//   mainloop of simt_tile.cuh (128 x 128 block tile, depth 16, 8 x 8
//   register micro-tile per thread), shared by the SIMT product kernels,
//   which differ only in operand layouts and epilogue; held to 128 registers
//   a thread (two blocks per SM). fp32 stays here on purpose: wgmma on fp32
//   is TF32 (10-bit mantissa).
//
// Layouts: h [n, d], W [d, V] and g [n, vc] contiguous, all in one dtype
// (fp32 or bf16); t int32 [n]; lse, tgt, s fp32 [n]; dh fp32 [n, d]; dW [d, V]
// in W's dtype. Products accumulate in fp32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.
// Each entry point returns a cudaError_t (0 = launched); it launches on the
// stream it is given and neither allocates nor synchronises.

#include <math.h>

#include "simt_tile.cuh"
#include "tc_tile.cuh"

namespace {

using namespace lpt;

// Reduce over the 16 threads that share a micro-tile row (ty): lanes
// 0-15 or 16-31 of one warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Forward: partial statistics per (token tile, vocab tile), then the merge.
// ---------------------------------------------------------------------------

// part_m / part_z / part_t: [n_vocab_tiles, n] fp32. part_t[j, i] is written
// only by the tile j that holds column t[i].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ce_stats_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ t,
                float* __restrict__ part_m, float* __restrict__ part_z,
                float* __restrict__ part_t, int n, int d, int v) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  __shared__ __align__(16) TileSmem smem;
  float acc[8][8];
  zero(acc);
  // logits = h W
  tile_product(acc, smem, Dense<T, true>{h, (size_t)d}, Dense<T, false>{w, (size_t)v}, m0, n0,
               n, v, d);

  const size_t part = (size_t)blockIdx.x * n;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + micro(ty, r);
    const int target = row < n ? t[row] : -1;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (n0 + micro(tx, c) < v) mx = fmaxf(mx, acc[r][c]);
    mx = row_max(mx);  // finite: every tile holds at least one column < v
    float z = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + micro(tx, c);
      if (col >= v) continue;
      z += expf(acc[r][c] - mx);
      if (col == target) part_t[part + row] = acc[r][c];
    }
    z = row_sum(z);
    if (tx == 0 && row < n) {
      part_m[part + row] = mx;
      part_z[part + row] = z;
    }
  }
}

// One thread per token: lse = M + log sum_j z_j exp(m_j - M), M = max_j m_j.
// `tile` is the vocab width of one partial (TILE, or tc::BN on the tensor cores).
__global__ void __launch_bounds__(NT)
ce_lse_kernel(const float* __restrict__ part_m, const float* __restrict__ part_z,
              const float* __restrict__ part_t, const int* __restrict__ t,
              float* __restrict__ lse, float* __restrict__ tgt, int n, int v, int n_tiles,
              int tile) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= n) return;
  float mx = -INFINITY;
  for (int j = 0; j < n_tiles; ++j) mx = fmaxf(mx, part_m[(size_t)j * n + row]);
  float z = 0.f;
  for (int j = 0; j < n_tiles; ++j)
    z += part_z[(size_t)j * n + row] * expf(part_m[(size_t)j * n + row] - mx);
  lse[row] = mx + logf(z);
  const int target = t[row];
  // a target no tile holds picks nothing (the TPU kernel's zero-initialised row)
  tgt[row] = (target >= 0 && target < v) ? part_t[(size_t)(target / tile) * n + row] : 0.f;
}

// ---------------------------------------------------------------------------
// Backward, per vocab chunk [c0, c0 + vc).
// ---------------------------------------------------------------------------

// g[i, j] = ((exp(l[i, c0 + j] - lse[i]) - (c0 + j == t[i])) * s[i]) in T.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ce_grad_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ t,
               const float* __restrict__ lse, const float* __restrict__ s, T* __restrict__ g,
               int n, int d, int v, int c0, int vc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  __shared__ __align__(16) TileSmem smem;
  float acc[8][8];
  zero(acc);
  // the chunk's logits
  tile_product(acc, smem, Dense<T, true>{h, (size_t)d}, Dense<T, false>{w + c0, (size_t)v}, m0,
               n0, n, vc, d);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + micro(ty, r);
    if (row >= n) continue;
    const float l = lse[row], sc = s[row];
    const int target = t[row] - c0;  // the chunk's column of the target, if it owns it
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + micro(tx, c);
      if (col >= vc) continue;
      const float p = expf(acc[r][c] - l);
      g[(size_t)row * vc + col] = from_f32<T>((p - (col == target ? 1.f : 0.f)) * sc);
    }
  }
}

// dh[i, :] (+)= sum_j g[i, j] W[:, c0 + j]: the first chunk writes, later ones add.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ce_dh_kernel(const T* __restrict__ g, const T* __restrict__ w, float* __restrict__ dh, int n,
             int d, int v, int c0, int vc, int accumulate) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  __shared__ __align__(16) TileSmem smem;
  float acc[8][8];
  zero(acc);
  // A(i, k) = g[i, k]; B(j, k) = W[j, c0 + k]: both contiguous along k
  tile_product(acc, smem, Dense<T, true>{g, (size_t)vc}, Dense<T, true>{w + c0, (size_t)v}, m0,
               n0, n, d, vc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + micro(ty, r);
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + micro(tx, c);
      if (col >= d) continue;
      float* out = dh + (size_t)row * d + col;
      *out = accumulate ? *out + acc[r][c] : acc[r][c];
    }
  }
}

// dW[:, c0 + j] = sum_i h[i, :] g[i, j], rounded once to T.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ g, T* __restrict__ dw, int n, int d,
             int v, int c0, int vc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  __shared__ __align__(16) TileSmem smem;
  float acc[8][8];
  zero(acc);
  // A(i, k) = h[k, i]; B(j, k) = g[k, j]: both contiguous along the output rows
  tile_product(acc, smem, Dense<T, false>{h, (size_t)d}, Dense<T, false>{g, (size_t)vc}, m0, n0,
               d, vc, n);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + micro(ty, r);
    if (row >= d) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n0 + micro(tx, c);
      if (col < vc) dw[(size_t)row * v + c0 + col] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// On the tensor cores (bf16): the forward over the whole vocab, and the
// backward per vocab chunk [c0, c0 + vc), with the same products and stores
// as above on tc_tile.cuh's mainloop. The epilogues read the wgmma
// accumulator layout: a thread owns rows row + 8h and column pairs
// col + 8j + {0, 1}; d, V and vc are multiples of 8, so a pair is in range
// whenever its first column is, and is stored as one 2-wide word.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The forward's partials of one 256-column vocab tile (part_* as for
// ce_stats_kernel, one row of n per tile). A row's 256 columns lie in the 4
// lanes of one quad (lane % 4), 64 each: each lane reduces its own, then
// two shuffles (xor 1, 2) combine the quad. Columns >= V (TMA's zeros, which
// would raise the max and add exp(-max) terms) are left out of both sums;
// every tile holds column n0 < V, so the quad's max is finite.
struct StatsStore {
  const int* __restrict__ t;
  float* __restrict__ part_m;
  float* __restrict__ part_z;
  float* __restrict__ part_t;
  int n, v;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
    const size_t part = (size_t)(col / tc::BN) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j)
        if (col + 8 * j < v) mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j)
        if (col + 8 * j < v)
          z += expf(acc[4 * j + 2 * h] - mx) + expf(acc[4 * j + 2 * h + 1] - mx);
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      if (r >= n) continue;  // after the shuffles, which every lane joins
      const int target = t[r];
#pragma unroll
      for (int j = 0; j < NA / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + 8 * j + e == target) part_t[part + r] = acc[4 * j + 2 * h + e];
      if (threadIdx.x % 4 == 0) {
        part_m[part + r] = mx;
        part_z[part + r] = z;
      }
    }
  }
};

struct GradStore {  // g[i, j] = ((exp(l - lse[i]) - (c0 + j == t[i])) * s[i]) in bf16
  const int* __restrict__ t;
  const float* __restrict__ lse;
  const float* __restrict__ s;
  bf16* __restrict__ g;
  int n, vc, c0;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= n) continue;
      const float l = lse[r], sc = s[r];
      const int target = t[r] - c0;  // the chunk's column of the target, if it owns it
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int c = col + 8 * j;
        if (c >= vc) continue;
        const float g0 = (expf(acc[4 * j + 2 * h] - l) - (c == target ? 1.f : 0.f)) * sc;
        const float g1 = (expf(acc[4 * j + 2 * h + 1] - l) - (c + 1 == target ? 1.f : 0.f)) * sc;
        *reinterpret_cast<__nv_bfloat162*>(g + (size_t)r * vc + c) = __floats2bfloat162_rn(g0, g1);
      }
    }
  }
};

// The logits over the whole vocab: A = h [n, d] (K-major), B(j, k) = W[k, j] (MN-major).
__global__ void __launch_bounds__(tc::THREADS, 1)
ce_stats_tc_kernel(const __grid_constant__ CUtensorMap h_map,
                   const __grid_constant__ CUtensorMap w_map, int n, int d, int v,
                   StatsStore out) {
  tc::tile_product<false, true>(h_map, w_map, n, v, d, out);
}

// The chunk's logits: A = h [n, d] (K-major), B(j, k) = W[k, c0 + j] (MN-major).
__global__ void __launch_bounds__(tc::THREADS, 1)
ce_grad_tc_kernel(const __grid_constant__ CUtensorMap h_map,
                  const __grid_constant__ CUtensorMap w_map, int n, int d, int vc, GradStore out) {
  tc::tile_product<false, true>(h_map, w_map, n, vc, d, out);
}

// A = g [n, vc] (K-major), B(j, k) = W[j, c0 + k] (K-major).
__global__ void __launch_bounds__(tc::THREADS, 1)
ce_dh_tc_kernel(const __grid_constant__ CUtensorMap g_map,
                const __grid_constant__ CUtensorMap w_map, int n, int d, int vc,
                tc::DhStore out) {
  tc::tile_product<false, false>(g_map, w_map, n, d, vc, out);
}

// A(i, k) = h[k, i] (MN-major), B(j, k) = g[k, j] (MN-major).
__global__ void __launch_bounds__(tc::THREADS, 1)
ce_dw_tc_kernel(const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap g_map, int n, int d, int vc,
                tc::BfStore out) {
  tc::tile_product<true, true>(h_map, g_map, d, vc, n, out);
}

cudaError_t launch_fwd_tc(const void* h, const void* w, const int* t, float* part_m,
                          float* part_z, float* part_t, float* lse, float* tgt, int n, int d,
                          int v, cudaStream_t stream) {
  CUtensorMap h_map, w_map;
  cudaError_t err = tc::make_map(&h_map, h, d, n, d);
  if (err == cudaSuccess) err = tc::make_map(&w_map, w, v, d, v);
  if (err == cudaSuccess)
    err = tc::launch(ce_stats_tc_kernel, n, v, stream, h_map, w_map, n, d, v,
                     StatsStore{t, part_m, part_z, part_t, n, v});
  if (err != cudaSuccess) return err;
  ce_lse_kernel<<<cdiv(n, NT), NT, 0, stream>>>(part_m, part_z, part_t, t, lse, tgt, n, v,
                                                cdiv(v, tc::BN), tc::BN);
  return cudaGetLastError();
}

cudaError_t launch_grad_tc(const void* h, const void* w, const int* t, const float* lse,
                           const float* s, void* g, int n, int d, int v, int c0, int vc,
                           cudaStream_t stream) {
  CUtensorMap h_map, w_map;
  cudaError_t err = tc::make_map(&h_map, h, d, n, d);
  if (err == cudaSuccess) err = tc::make_map(&w_map, static_cast<const bf16*>(w) + c0, vc, d, v);
  if (err != cudaSuccess) return err;
  return tc::launch(ce_grad_tc_kernel, n, vc, stream, h_map, w_map, n, d, vc,
                             GradStore{t, lse, s, static_cast<bf16*>(g), n, vc, c0});
}

cudaError_t launch_dh_tc(const void* g, const void* w, float* dh, int n, int d, int v, int c0,
                         int vc, int accumulate, cudaStream_t stream) {
  CUtensorMap g_map, w_map;
  cudaError_t err = tc::make_map(&g_map, g, vc, n, vc);
  if (err == cudaSuccess) err = tc::make_map(&w_map, static_cast<const bf16*>(w) + c0, vc, d, v);
  if (err != cudaSuccess) return err;
  return tc::launch(ce_dh_tc_kernel, n, d, stream, g_map, w_map, n, d, vc,
                           tc::DhStore{dh, n, d, accumulate});
}

cudaError_t launch_dw_tc(const void* h, const void* g, void* dw, int n, int d, int v, int c0,
                         int vc, cudaStream_t stream) {
  CUtensorMap h_map, g_map;
  cudaError_t err = tc::make_map(&h_map, h, d, n, d);
  if (err == cudaSuccess) err = tc::make_map(&g_map, g, vc, n, vc);
  if (err != cudaSuccess) return err;
  return tc::launch(ce_dw_tc_kernel, d, vc, stream, h_map, g_map, n, d, vc,
                           tc::BfStore{static_cast<bf16*>(dw), d, v, c0, vc});
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_fwd(const void* h, const void* w, const int* t, float* part_m, float* part_z,
                       float* part_t, float* lse, float* tgt, int n, int d, int v,
                       cudaStream_t stream) {
  const int n_tiles = cdiv(v, TILE);
  ce_stats_kernel<T><<<dim3(n_tiles, cdiv(n, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), t, part_m, part_z, part_t, n, d, v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_lse_kernel<<<cdiv(n, NT), NT, 0, stream>>>(part_m, part_z, part_t, t, lse, tgt, n, v,
                                                n_tiles, TILE);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad(const void* h, const void* w, const int* t, const float* lse,
                        const float* s, void* g, int n, int d, int v, int c0, int vc,
                        cudaStream_t stream) {
  ce_grad_kernel<T><<<dim3(cdiv(vc, TILE), cdiv(n, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), t, lse, s, static_cast<T*>(g), n, d,
      v, c0, vc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* g, const void* w, float* dh, int n, int d, int v, int c0,
                      int vc, int accumulate, cudaStream_t stream) {
  ce_dh_kernel<T><<<dim3(cdiv(d, TILE), cdiv(n, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), dh, n, d, v, c0, vc, accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* h, const void* g, void* dw, int n, int d, int v, int c0,
                      int vc, cudaStream_t stream) {
  ce_dw_kernel<T><<<dim3(cdiv(vc, TILE), cdiv(d, TILE)), NT, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(g), static_cast<T*>(dw), n, d, v, c0, vc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of one vocab tile of the forward: part_* hold cdiv(v, it) rows
// (lpt_ce_fwd; lpt_ce_fwd_tc's tiles are lpt_ce_vocab_tile_tc() wide).
int lpt_ce_vocab_tile() { return TILE; }
int lpt_ce_vocab_tile_tc() { return tc::BN; }

int lpt_ce_fwd(const void* h, const void* w, const int* t, float* part_m, float* part_z,
               float* part_t, float* lse, float* tgt, int n, int d, int v, int dtype,
               void* stream) {
#define CALL(T) \
  launch_fwd<T>(h, w, t, part_m, part_z, part_t, lse, tgt, n, d, v, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

int lpt_ce_grad(const void* h, const void* w, const int* t, const float* lse, const float* s,
                void* g, int n, int d, int v, int c0, int vc, int dtype, void* stream) {
#define CALL(T) \
  launch_grad<T>(h, w, t, lse, s, g, n, d, v, c0, vc, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

int lpt_ce_dh(const void* g, const void* w, float* dh, int n, int d, int v, int c0, int vc,
              int accumulate, int dtype, void* stream) {
#define CALL(T) \
  launch_dh<T>(g, w, dh, n, d, v, c0, vc, accumulate, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

int lpt_ce_dw(const void* h, const void* g, void* dw, int n, int d, int v, int c0, int vc,
              int dtype, void* stream) {
#define CALL(T) launch_dw<T>(h, g, dw, n, d, v, c0, vc, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, CALL);
#undef CALL
}

// bf16 on the tensor cores: the arguments of lpt_ce_fwd, lpt_ce_grad,
// lpt_ce_dh and lpt_ce_dw without the dtype. d, V and vc multiples of 8; h,
// w, g 16-byte aligned.
int lpt_ce_fwd_tc(const void* h, const void* w, const int* t, float* part_m, float* part_z,
                  float* part_t, float* lse, float* tgt, int n, int d, int v, void* stream) {
  return launch_fwd_tc(h, w, t, part_m, part_z, part_t, lse, tgt, n, d, v,
                       static_cast<cudaStream_t>(stream));
}

int lpt_ce_grad_tc(const void* h, const void* w, const int* t, const float* lse, const float* s,
                   void* g, int n, int d, int v, int c0, int vc, void* stream) {
  return launch_grad_tc(h, w, t, lse, s, g, n, d, v, c0, vc, static_cast<cudaStream_t>(stream));
}

int lpt_ce_dh_tc(const void* g, const void* w, float* dh, int n, int d, int v, int c0, int vc,
                 int accumulate, void* stream) {
  return launch_dh_tc(g, w, dh, n, d, v, c0, vc, accumulate, static_cast<cudaStream_t>(stream));
}

int lpt_ce_dw_tc(const void* h, const void* g, void* dw, int n, int d, int v, int c0, int vc,
                 void* stream) {
  return launch_dw_tc(h, g, dw, n, d, v, c0, vc, static_cast<cudaStream_t>(stream));
}

const char* lpt_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
