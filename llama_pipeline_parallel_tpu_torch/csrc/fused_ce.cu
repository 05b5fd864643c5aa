// Fused lm-head + cross-entropy for Hopper: forward statistics, dh and dW.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/pallas_ce.py:
//   ce_stats_kernel + ce_lse_kernel  <- _fwd_kernel (pallas_call in _fwd_stats)
//   ce_grad_kernel  + ce_dh_kernel   <- _dh_kernel  (first pallas_call in _backward)
//   ce_grad_kernel  + ce_dw_kernel   <- _dw_kernel  (second pallas_call in _backward)
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
// - forward: one block per 128 x 128 (token, vocab) tile computes its logits
//   and reduces each row to a partial (max, sum of exps) and, for the one tile
//   that holds the row's target column, the target logit; a second small
//   kernel merges the partials of a row with the online-lse rule,
//   lse = M + log sum_j z_j exp(m_j - M). The grid covers the whole vocab
//   (4000 blocks at n 2048, V 32000), not one block per token block (32).
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
// bytes, so the bound is the tensor-core rate. This first version does the
// products with scalar fp32 FMAs: one tiled mainloop (128 x 128 block tile,
// depth 16, fp32 copies in shared memory, 8 x 8 register micro-tile per
// thread fed by float4 loads, the next depth tile's global loads in flight
// during this tile's FMAs) shared by all four product kernels, which differ
// only in operand layouts and epilogue. Tensor cores (wgmma), TMA and a
// pipelined ring of tiles are the next step and change none of the above.
// The product kernels are held to 128 registers a thread (two blocks per SM).
//
// Layouts: h [n, d], W [d, V] and g [n, vc] contiguous, all in one dtype
// (fp32 or bf16); t int32 [n]; lse, tgt, s fp32 [n]; dh fp32 [n, d]; dW [d, V]
// in W's dtype. Products accumulate in fp32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.
// Each entry point returns a cudaError_t (0 = launched); it launches on the
// stream it is given and neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Offset of a thread's micro-tile row (or column) r in 0..7 inside the tile:
// rows q * 4 .. q * 4 + 3 and 64 + q * 4 .. 64 + q * 4 + 3 for thread
// coordinate q (ty for rows, tx for columns).
__device__ __forceinline__ int micro(int q, int r) { return (r < 4 ? 0 : 64) + q * 4 + (r & 3); }

// An operand X(r, k) of the product, r in [0, rows), k in [0, depth): stored
// K-contiguous (X[r * ld + k]) or R-contiguous (X[k * ld + r]). Each thread
// loads 8 elements of the [TILE, BK] tile at (r0, k0) into registers, as
// fp32, zero past the edges; neighbouring threads read neighbouring addresses.
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

template <typename T, bool K_CONTIG>
__device__ __forceinline__ void load_tile(float (&reg)[8], const T* __restrict__ x, size_t ld,
                                          int r0, int k0, int rows, int depth) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    int r, k;
    tile_coords<K_CONTIG>(e, r, k);
    const int gr = r0 + r, gk = k0 + k;
    float v = 0.f;
    if (gr < rows && gk < depth)
      v = to_f32(x[K_CONTIG ? (size_t)gr * ld + gk : (size_t)gk * ld + gr]);
    reg[e] = v;
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

// acc[r][c] = sum_k A(m0 + micro(ty, r), k) * B(n0 + micro(tx, c), k) over
// k in [0, K): the one product every kernel below is built from. A has M
// rows, B has N rows (the output's columns); elements past M, N or K count
// as zero.
template <typename T, bool A_KC, bool B_KC>
__device__ __forceinline__ void tile_product(float (&acc)[8][8], const T* __restrict__ a,
                                             size_t lda, const T* __restrict__ b, size_t ldb,
                                             int m0, int n0, int M, int N, int K) {
  __shared__ __align__(16) float a_s[BK][LDT];
  __shared__ __align__(16) float b_s[BK][LDT];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  float ra[8], rb[8];
  load_tile<T, A_KC>(ra, a, lda, m0, 0, M, K);
  load_tile<T, B_KC>(rb, b, ldb, n0, 0, N, K);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_tile<A_KC>(a_s, ra);
    store_tile<B_KC>(b_s, rb);
    __syncthreads();
    if (k0 + BK < K) {  // the next depth tile's loads fly while this one's FMAs run
      load_tile<T, A_KC>(ra, a, lda, m0, k0 + BK, M, K);
      load_tile<T, B_KC>(rb, b, ldb, n0, k0 + BK, N, K);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[k][64 + tx * 4]);
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
  float acc[8][8];
  tile_product<T, true, false>(acc, h, d, w, v, m0, n0, n, v, d);  // logits = h W

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
__global__ void __launch_bounds__(NT)
ce_lse_kernel(const float* __restrict__ part_m, const float* __restrict__ part_z,
              const float* __restrict__ part_t, const int* __restrict__ t,
              float* __restrict__ lse, float* __restrict__ tgt, int n, int v, int n_tiles) {
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
  tgt[row] = (target >= 0 && target < v) ? part_t[(size_t)(target / TILE) * n + row] : 0.f;
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
  float acc[8][8];
  tile_product<T, true, false>(acc, h, d, w + c0, v, m0, n0, n, vc, d);  // the chunk's logits
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
  float acc[8][8];
  // A(i, k) = g[i, k]; B(j, k) = W[j, c0 + k]: both contiguous along k
  tile_product<T, true, true>(acc, g, vc, w + c0, v, m0, n0, n, d, vc);
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
  float acc[8][8];
  // A(i, k) = h[k, i]; B(j, k) = g[k, j]: both contiguous along the output rows
  tile_product<T, false, false>(acc, h, d, g, vc, m0, n0, d, vc, n);
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
// Launchers
// ---------------------------------------------------------------------------

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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
                                                n_tiles);
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

// dtype: 0 = float32, 1 = bfloat16.
#define LPT_DISPATCH(DTYPE, CALL)                              \
  do {                                                         \
    if ((DTYPE) == 0) return (int)CALL(float);                 \
    if ((DTYPE) == 1) return (int)CALL(__nv_bfloat16);         \
    return (int)cudaErrorInvalidValue;                         \
  } while (0)

extern "C" {

// Columns of one vocab tile of the forward: part_* hold cdiv(v, it) rows.
int lpt_ce_vocab_tile() { return TILE; }

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

const char* lpt_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
