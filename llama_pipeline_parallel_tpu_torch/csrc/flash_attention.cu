// Flash attention (FlashAttention-2 schedule) for Hopper: forward, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/flash_attention.py:
//   fwd_tc_kernel (bf16), fwd_kernel (fp32)   <- _fwd_kernel     (pallas_call in _fwd)
//   bwd_dq_tc_kernel (bf16), bwd_dq_kernel (fp32)
//                                             <- _bwd_dq_kernel  (first pallas_call in _bwd)
//   bwd_dkv_tc_kernel (bf16), bwd_dkv_kernel (fp32)
//                                             <- _bwd_dkv_kernel (second pallas_call in _bwd)
//
// What they compute is the TPU kernels' contract, not their block structure.
// The TPU walks a sequential grid axis and carries the softmax state in VMEM
// scratch from one grid step to the next; here one thread block owns one
// (batch, head, q tile) and loops over the KV tiles itself (forward, dq), or
// owns one (batch, head, kv tile) and loops over the q tiles (dk/dv). Every
// output element is written by exactly one block, so no atomics are needed.
//
// Semantics kept from the reference (both routes):
// - causal masking on global positions (q_offset / kv_offset), and tiles
//   that the causal predicate masks completely are skipped;
// - optional segment ids (0 = pad): a score survives only where the q row and
//   the kv column carry the same nonzero id;
// - GQA in the forward without materialising grouped K/V: kv head = h / group;
//   the backward takes K/V already expanded to the q heads, as the reference;
// - masked scores are NEG_INF = -1e30 (finite); p = 0 where s <= NEG_INF / 2,
//   so a row that sees no key finalises to out = 0, lse = NEG_INF, and the
//   backward gives it p = 0 everywhere.
//
// What bounds these kernels on the card: at the shapes of the training step
// (head_dim 128, sequence 2048) attention is compute-bound (about 2 * hd
// operations per loaded byte per tile pair), so the bound is the tensor-core
// rate. Two routes:
// - bf16 (the training path), every kernel: wgmma fed by TMA (the PTX
//   wrappers of tc_tile.cuh). One producer warpgroup gives its registers
//   away (setmaxnreg) and TMA-loads 64 x 64 boxes in the 128-byte swizzle
//   from 3-D maps over (hd, s, b * heads), so ragged tiles read zeros and
//   never the next head's rows; two consumer warpgroups own 64 rows each.
//   The forward takes q tiles of 128 rows and streams K and V tiles of 128
//   rows through a 2-stage ring (K and V behind separate barriers, so that
//   S = Q K^T starts before V lands); the online softmax runs in the wgmma
//   accumulator layout (a row spread over a quad of 4 threads: two
//   __shfl_xor_sync), in log2 units. dq keeps a q tile of 128 rows (with
//   its rows' lse, delta and segment ids in registers) and streams K and V
//   tiles of 64 rows through a 4-stage ring; dk/dv keeps a kv tile of 128
//   rows and streams q tiles of 32 rows with their lse, delta and segment
//   ids through a 4-stage ring. P, dS and dS^T feed their products from
//   registers (RS: an accumulator's 16-column slice is an A fragment once
//   packed to bf16x2), as a hi + lo pair of bf16: one bf16 put outputs
//   where a few large terms cancel past the 2^-8 limit.
//   Masks are evaluated in registers only on tiles that can hide a score.
// - fp32 (every kernel): scalar fp32 FMAs out of shared memory
//   (wgmma on fp32 would be TF32): each thread owns a 4 x (N / 16) register
//   micro-tile, so every shared-memory load feeds 2 to 4 FMAs, and the tiles
//   are stored with one float of row padding so that the loads of a warp
//   fall on distinct banks.
//
// Layouts: q/k/v/out/dO/dq/dk/dv are contiguous [b, heads, s, hd] in fp32 or
// bf16 (all the same type); lse and delta are contiguous fp32 [b, h, sq]
// (the [b, h, sq, 1] arrays of the reference); segment ids are int32 [b, s].
// Products accumulate in fp32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.
// Each entry point returns a cudaError_t (0 = launched); it launches on the
// stream it is given and neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // kv rows per tile
constexpr int NT = 256;          // threads per block, seen as a 16 x 16 grid
constexpr int LDS = BK + 1;      // row stride of a [BQ, BK] score tile in shared memory
constexpr float NEG_INF = -1e30f;

// the SIMT kernels are instantiated for fp32 only (bf16 takes the tensor cores)
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Copy rows [row0, row0 + 64) of a [n_rows, HD] matrix into shared memory as
// fp32 with row stride HD + 1, multiplied by `mul`; rows past n_rows are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int n_rows,
                                          float mul) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    const int gr = row0 + r;
    dst[r * (HD + 1) + c] = gr < n_rows ? to_f32(src[(size_t)gr * HD + c]) * mul : 0.f;
  }
}

// acc[r][c] += sum_k A(ty * 4 + r, k) * B(k, tx + 16 * c), with
// A(i, k) = A[i * A_RS + k * A_KS] and B(k, j) = B[k * B_KS + j * B_CS]:
// the one product every kernel below is built from (each transpose is a choice
// of strides). Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty * 4 .. + 3
// and the columns tx, tx + 16, ... of a 64 x (16 * C) result.
template <int C, int K, int A_RS, int A_KS, int B_KS, int B_CS>
__device__ __forceinline__ void mma_tile(float (&acc)[4][C], const float* A, const float* B) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* a_base = A + (ty * 4) * A_RS;
  const float* b_base = B + tx * B_CS;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[C];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = a_base[r * A_RS + k * A_KS];
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = b_base[k * B_KS + 16 * c * B_CS];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// Whether score (i, j) of the tile pair (q0, k0) survives the masks.
__device__ __forceinline__ bool visible(int i, int j, int q0, int k0, int skv, int causal,
                                        int q_offset, int kv_offset, const int* segq_s,
                                        const int* segk_s, bool has_seg) {
  bool ok = k0 + j < skv;
  if (causal) ok = ok && (q_offset + q0 + i >= kv_offset + k0 + j);
  if (has_seg) ok = ok && segk_s[j] != 0 && segq_s[i] == segk_s[j];
  return ok;
}

__device__ __forceinline__ void load_segments(int* dst, const int* seg, int row0, int n_rows) {
  // without segment ids every position counts as segment 1 (never read then)
  for (int t = threadIdx.x; t < 64; t += NT)
    dst[t] = seg == nullptr ? 1 : (row0 + t < n_rows ? seg[row0 + t] : 0);
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, head, batch); online softmax over KV tiles.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ seg_q, const int* __restrict__ seg_kv, T* __restrict__ out,
           float* __restrict__ lse, int h, int h_kv, int sq, int skv, float scale, int causal,
           int q_offset, int kv_offset) {
  constexpr int LD = HD + 1;
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ, LD], pre-scaled
  float* kv_s = q_s + BQ * LD;       // [BK, LD]: the K tile, then the V tile
  float* s_s = kv_s + BK * LD;       // [BQ, LDS]: scores, then probabilities
  float* m_s = s_s + BQ * LDS;       // [BQ] running max
  float* l_s = m_s + BQ;             // [BQ] running sum
  float* corr_s = l_s + BQ;          // [BQ] this tile's rescale factor
  int* segq_s = reinterpret_cast<int*>(corr_s + BQ);  // [BQ]
  int* segk_s = segq_s + BQ;                          // [BK]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the last q tiles see the most keys under the causal mask: start them first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int group = h / h_kv;
  const int q0 = qi * BQ;
  const bool has_seg = seg_q != nullptr;
  const T* qp = q + (size_t)(bb * h + hh) * sq * HD;
  const T* kp = k + (size_t)(bb * h_kv + hh / group) * skv * HD;
  const T* vp = v + (size_t)(bb * h_kv + hh / group) * skv * HD;

  load_tile<T, HD>(q_s, qp, q0, sq, scale);
  load_segments(segq_s, has_seg ? seg_q + (size_t)bb * sq : nullptr, q0, sq);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float o[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) o[r][c] = 0.f;

  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int n_k = (skv + BK - 1) / BK;
  for (int ki = 0; ki < n_k; ++ki) {
    const int k0 = ki * BK;
    if (causal && q_last < kv_offset + k0) break;  // this and every later tile is masked
    __syncthreads();  // the previous tile's readers of kv_s / s_s are done
    load_tile<T, HD>(kv_s, kp, k0, skv, 1.f);
    load_segments(segk_s, has_seg ? seg_kv + (size_t)bb * skv : nullptr, k0, skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    mma_tile<4, HD, LD, 1, 1, LD>(s, q_s, kv_s);  // S = (Q * scale) K^T
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty * 4 + r, j = tx + 16 * c;
        s_s[i * LDS + j] = visible(i, j, q0, k0, skv, causal, q_offset, kv_offset, segq_s,
                                   segk_s, has_seg)
                               ? s[r][c]
                               : NEG_INF;
      }
    __syncthreads();

    // K is consumed: stream the V tile in while four threads per row update
    // the row's max / sum and turn its scores into probabilities.
    load_tile<T, HD>(kv_s, vp, k0, skv, 1.f);
    {
      const int row = tid / 4, part = tid % 4;
      float* srow = s_s + row * LDS + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float sv = srow[c];
        // masked scores add nothing, even when the whole row is masked
        const float p = sv > NEG_INF / 2 ? expf(sv - m_cur) : 0.f;
        srow[c] = p;
        sum += p;
      }
      // the shuffles also order every read of m_s[row] before the write below
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_cur);
        corr_s[row] = corr;
        l_s[row] = corr * l_s[row] + sum;
        m_s[row] = m_cur;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = corr_s[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < C; ++c) o[r][c] *= corr;
    }
    mma_tile<C, BK, LDS, 1, LD, 1>(o, s_s, kv_s);  // O += P V
  }
  __syncthreads();  // l_s / m_s final (also when every tile was skipped)

  T* op = out + (size_t)(bb * h + hh) * sq * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    if (q0 + i >= sq) continue;
    const float l = l_s[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
      op[(size_t)(q0 + i) * HD + tx + 16 * c] = from_f32<T>(l > 0.f ? o[r][c] / l : 0.f);
  }
  if (tid < BQ && q0 + tid < sq) {
    const float l = l_s[tid];
    // logsumexp residual for the backward; NEG_INF marks a row with no key
    lse[(size_t)(bb * h + hh) * sq + q0 + tid] = l > 0.f ? m_s[tid] + logf(l) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// Backward dq: one block per (q tile, head, batch); loop over KV tiles.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ seg_q,
              const int* __restrict__ seg_kv, T* __restrict__ dq, int h, int sq, int skv,
              float scale, int causal, int q_offset, int kv_offset) {
  constexpr int LD = HD + 1;
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ, LD], pre-scaled
  float* do_s = q_s + BQ * LD;      // [BQ, LD]
  float* k_s = do_s + BQ * LD;      // [BK, LD]
  float* v_s = k_s + BK * LD;       // [BK, LD]
  float* ds_s = v_s + BK * LD;      // [BQ, LDS]
  float* lse_s = ds_s + BQ * LDS;   // [BQ]
  float* delta_s = lse_s + BQ;      // [BQ]
  int* segq_s = reinterpret_cast<int*>(delta_s + BQ);
  int* segk_s = segq_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int q0 = qi * BQ;
  const bool has_seg = seg_q != nullptr;
  const size_t qoff = (size_t)(bb * h + hh) * sq * HD;
  const size_t koff = (size_t)(bb * h + hh) * skv * HD;
  const size_t roff = (size_t)(bb * h + hh) * sq;

  load_tile<T, HD>(q_s, q + qoff, q0, sq, scale);
  load_tile<T, HD>(do_s, dout + qoff, q0, sq, 1.f);
  load_segments(segq_s, has_seg ? seg_q + (size_t)bb * sq : nullptr, q0, sq);
  if (tid < BQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[roff + q0 + tid] : NEG_INF;
    delta_s[tid] = in ? delta[roff + q0 + tid] : 0.f;
  }
  float acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int n_k = (skv + BK - 1) / BK;
  for (int ki = 0; ki < n_k; ++ki) {
    const int k0 = ki * BK;
    if (causal && q_last < kv_offset + k0) break;
    __syncthreads();
    load_tile<T, HD>(k_s, k + koff, k0, skv, 1.f);
    load_tile<T, HD>(v_s, v + koff, k0, skv, 1.f);
    load_segments(segk_s, has_seg ? seg_kv + (size_t)bb * skv : nullptr, k0, skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    mma_tile<4, HD, LD, 1, 1, LD>(s, q_s, k_s);    // S = (Q * scale) K^T
    mma_tile<4, HD, LD, 1, 1, LD>(dp, do_s, v_s);  // dP = dO V^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      const float l = lse_s[i], dl = delta_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float sv = visible(i, j, q0, k0, skv, causal, q_offset, kv_offset, segq_s,
                                 segk_s, has_seg)
                             ? s[r][c]
                             : NEG_INF;
        const float p = l > NEG_INF / 2 ? expf(sv - l) : 0.f;
        ds_s[i * LDS + j] = p * (dp[r][c] - dl);
      }
    }
    __syncthreads();
    mma_tile<C, BK, LDS, 1, LD, 1>(acc, ds_s, k_s);  // dQ += dS K
  }

  T* dqp = dq + qoff;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty * 4 + r;
    if (q0 + i >= sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dqp[(size_t)(q0 + i) * HD + tx + 16 * c] = from_f32<T>(scale * acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// Backward dk/dv: one block per (kv tile, head, batch); loop over q tiles.
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, const int* __restrict__ seg_q,
               const int* __restrict__ seg_kv, T* __restrict__ dk, T* __restrict__ dv, int h,
               int sq, int skv, float scale, int causal, int q_offset, int kv_offset) {
  constexpr int LD = HD + 1;
  constexpr int C = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                // [BK, LD]
  float* v_s = k_s + BK * LD;       // [BK, LD]
  float* q_s = v_s + BK * LD;       // [BQ, LD], pre-scaled
  float* do_s = q_s + BQ * LD;      // [BQ, LD]
  float* p_s = do_s + BQ * LD;      // [BQ, LDS]
  float* ds_s = p_s + BQ * LDS;     // [BQ, LDS]
  float* lse_s = ds_s + BQ * LDS;   // [BQ]
  float* delta_s = lse_s + BQ;      // [BQ]
  int* segq_s = reinterpret_cast<int*>(delta_s + BQ);
  int* segk_s = segq_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ki = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int k0 = ki * BK;
  const bool has_seg = seg_q != nullptr;
  const size_t qoff = (size_t)(bb * h + hh) * sq * HD;
  const size_t koff = (size_t)(bb * h + hh) * skv * HD;
  const size_t roff = (size_t)(bb * h + hh) * sq;

  load_tile<T, HD>(k_s, k + koff, k0, skv, 1.f);
  load_tile<T, HD>(v_s, v + koff, k0, skv, 1.f);
  load_segments(segk_s, has_seg ? seg_kv + (size_t)bb * skv : nullptr, k0, skv);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int n_q = (sq + BQ - 1) / BQ;
  for (int qi = 0; qi < n_q; ++qi) {
    const int q0 = qi * BQ;
    // q tiles become visible as qi grows: skip the ones the causal mask hides
    if (causal && q_offset + min(q0 + BQ, sq) - 1 < kv_offset + k0) continue;
    __syncthreads();
    load_tile<T, HD>(q_s, q + qoff, q0, sq, scale);
    load_tile<T, HD>(do_s, dout + qoff, q0, sq, 1.f);
    load_segments(segq_s, has_seg ? seg_q + (size_t)bb * sq : nullptr, q0, sq);
    if (tid < BQ) {
      const bool in = q0 + tid < sq;
      lse_s[tid] = in ? lse[roff + q0 + tid] : NEG_INF;  // rows past sq give p = 0
      delta_s[tid] = in ? delta[roff + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    mma_tile<4, HD, LD, 1, 1, LD>(s, q_s, k_s);    // S = (Q * scale) K^T
    mma_tile<4, HD, LD, 1, 1, LD>(dp, do_s, v_s);  // dP = dO V^T
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty * 4 + r;
      const float l = lse_s[i], dl = delta_s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const float sv = visible(i, j, q0, k0, skv, causal, q_offset, kv_offset, segq_s,
                                 segk_s, has_seg)
                             ? s[r][c]
                             : NEG_INF;
        const float p = l > NEG_INF / 2 ? expf(sv - l) : 0.f;
        p_s[i * LDS + j] = p;
        ds_s[i * LDS + j] = p * (dp[r][c] - dl);
      }
    }
    __syncthreads();
    // rows of these products are kv rows: A(j, i) = P[i, j] is the transpose
    mma_tile<C, BQ, 1, LDS, LD, 1>(dv_acc, p_s, do_s);  // dV += P^T dO
    // Q was loaded pre-scaled, so dS^T Q already carries the 1 / sqrt(hd)
    mma_tile<C, BQ, 1, LDS, LD, 1>(dk_acc, ds_s, q_s);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty * 4 + r;
    if (k0 + j >= skv) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t at = koff + (size_t)(k0 + j) * HD + tx + 16 * c;
      dk[at] = from_f32<T>(dk_acc[r][c]);
      dv[at] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: forward, dq and dk/dv (head_dim 128)
// ---------------------------------------------------------------------------

namespace tc = lpt::tc;
using bf16 = __nv_bfloat16;

constexpr int TC_HD = 128;                  // the one head_dim of the tensor-core route
constexpr uint32_t BOX = tc::BOX_BYTES;     // a 64 x 64 bf16 TMA box: 8 KB
constexpr uint32_t TILE128 = 4 * BOX;       // 128 rows x hd 128: 32 KB
constexpr int TC_THREADS = 3 * 128;         // consumer warpgroups 0 and 1, producer 2
constexpr int PRODUCER_WARP = 8;            // the first warp of the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// TMA-load rows [r0, r0 + 128) x hd [0, 128) of layer `layer` (one batch
// row and head) into a tile of two row boxes. Box (hd chunk dc, row box rb)
// goes to tile + (2 dc + rb) BOX, so that each chunk's rows are contiguous
// as a K-major operand reads them; with MN (the forward's V: its rows are
// the product's depth) to tile + (2 rb + dc) BOX, so that the two hd chunks
// of a row box lie one box apart as an MN-major operand reads them. Rows
// past the map's extent read as zeros.
template <bool MN>
__device__ __forceinline__ void load_tile128(uint32_t tile, const CUtensorMap* map, uint32_t bar,
                                             int r0, int layer) {
#pragma unroll
  for (int dc = 0; dc < 2; ++dc)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
      tc::tma_load_3d(tile + (MN ? 2 * rb + dc : 2 * dc + rb) * BOX, map, bar, 64 * dc,
                      r0 + 64 * rb, layer);
}

// Descriptor of depth slice kk (hd 16kk .. 16kk + 15) of the K-major operand
// made of the rows of row boxes rb0 .. of a 128-row tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rb0, int kk) {
  return tc::operand_desc<false>(tile + ((kk / 4) * 2 + rb0) * BOX, kk % 4);
}

// Descriptor of depth slice kk (rows 16kk .. 16kk + 15) of the MN-major
// operand whose depth is a tile's rows and whose 128 columns are hd, the
// tile's two hd chunks one box apart (the MN placement above).
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return tc::operand_desc<true>(tile + (kk / 4) * 2 * BOX, kk % 4);
}

// The 1024-aligned base of the dynamic shared memory, as a shared address
// and as a generic pointer.
__device__ __forceinline__ uint32_t tc_base(uint8_t* smem, uint8_t** ptr) {
  const uint32_t raw = tc::smem_addr(smem), base = (raw + 1023u) & ~1023u;
  *ptr = smem + (base - raw);
  return base;
}

// Forward. Shared memory: Q (128 rows), then per stage the K tile and the V
// tile (128 rows each), then per stage the kv tile's 128 segment ids, then
// the mbarriers q_full, k_full[], v_full[], empty[].
constexpr int FWD_STAGES = 2;
constexpr uint32_t FWD_SEG = TILE128 + FWD_STAGES * 2 * TILE128;
constexpr uint32_t FWD_BARS = FWD_SEG + FWD_STAGES * 128 * 4;
constexpr int FWD_SMEM = FWD_BARS + 8 * (1 + 3 * FWD_STAGES) + 1024;

// One block per (head, q tile of 128 rows, batch row): the last q tiles,
// which see the most keys under the causal mask, first.
__global__ void __launch_bounds__(TC_THREADS, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const int* __restrict__ seg_q,
              const int* __restrict__ seg_kv, bf16* __restrict__ out, float* __restrict__ lse,
              int h, int h_kv, int sq, int skv, float scale, int causal, int q_offset,
              int kv_offset) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* smem;
  const uint32_t base = tc_base(tc_smem, &smem);
  int* segk_s = reinterpret_cast<int*>(smem + FWD_SEG);
  const uint32_t q_full = base + FWD_BARS, k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * FWD_STAGES, empty = v_full + 8 * FWD_STAGES;
  const int hh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128, bb = blockIdx.z;
  const int bh = bb * h + hh, bh_kv = bb * h_kv + hh / (h / h_kv);
  const bool has_seg = seg_q != nullptr;
  // the kv tiles this q tile sees: under the causal mask, up to its last row
  int n_tiles = tc::cdiv(skv, 128);
  if (causal) {
    const int reach = q_offset + min(q0 + 128, sq) - 1 - kv_offset;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / 128 + 1);
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      tc::mbar_init(k_full + 8 * s, 1 + 32);  // the TMA bytes and the producer warp's ids
      tc::mbar_init(v_full + 8 * s, 1);
      tc::mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp; lane 0 issues the TMA loads, every lane writes ids
    tc::setmaxnreg_dec<40>();
    if (threadIdx.x / 32 != PRODUCER_WARP || n_tiles == 0) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tc::mbar_expect_tx(q_full, TILE128);
      load_tile128<false>(base, &q_map, q_full, q0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % FWD_STAGES, k0 = it * 128;
      tc::mbar_wait(empty + 8 * s, ((it / FWD_STAGES) & 1) ^ 1);  // the first round passes
      const uint32_t kt = base + TILE128 + s * 2 * TILE128;
      if (lane == 0) {
        tc::mbar_expect_tx(k_full + 8 * s, TILE128);
        load_tile128<false>(kt, &k_map, k_full + 8 * s, k0, bh_kv);
        tc::mbar_expect_tx(v_full + 8 * s, TILE128);
        load_tile128<true>(kt + TILE128, &v_map, v_full + 8 * s, k0, bh_kv);
      }
      // the tile's segment ids: 0 (pad) past skv, 1 everywhere without segments
      for (int c = lane; c < 128; c += 32) {
        const int kp = k0 + c;
        segk_s[s * 128 + c] = kp >= skv ? 0 : has_seg ? seg_kv[(size_t)bb * skv + kp] : 1;
      }
      tc::mbar_arrive(k_full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread rows
  // row and row + 8, columns col + 8j + e of each kv tile (the accumulator
  // layout of tc_tile.cuh)
  tc::setmaxnreg_inc<232>();
  const int lane = threadIdx.x % 32;
  const int row = q0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  int segq[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    segq[h2] = r >= sq ? 0 : has_seg ? seg_q[(size_t)bb * sq + r] : 1;
  }
  // scores in log2 units: x = s * scale * log2(e), so that p = 2^(x - m)
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  if (n_tiles > 0) tc::mbar_wait(q_full, 0);
  // Before every wgmma.fence, the registers a wgmma reads are pinned
  // (fence_acc, fence_regs): the fence orders memory only, so the compiler
  // could otherwise move their last writes after it, where the tensor cores
  // may not see them.

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % FWD_STAGES, k0 = it * 128;
    const uint32_t parity = (it / FWD_STAGES) & 1;
    const uint32_t kt = base + TILE128 + s * 2 * TILE128, vt = kt + TILE128;

    // S = Q K^T: 64 x 128, depth hd in 8 slices, both operands K-major
    float sc[64];
    tc::mbar_wait(k_full + 8 * s, parity);
    tc::fence_acc(sc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::WgmmaSS<128, false, false>::run(sc, kmajor(base, wg, kk), kmajor(kt, 0, kk), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(sc);

#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= sl2;
    // masks only where they can hide a score: past skv, with segments, and
    // on tiles the causal diagonal crosses for this warpgroup's rows
    if (has_seg || k0 + 128 > skv ||
        (causal && q_offset + q0 + 64 * wg < kv_offset + k0 + 127)) {
      const int* sk = segk_s + s * 128;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + 8 * j + e, id = sk[c];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const bool ok = id != 0 && id == segq[h2] &&
                            (!causal || q_offset + row + 8 * h2 >= kv_offset + k0 + c);
            if (!ok) sc[4 * j + 2 * h2 + e] = NEG_INF;
          }
        }
    }

    // online softmax per row: the row max over the quad's 4 threads, the
    // rescale of O and l, then P = 2^(x - m) (0 where masked, also when the
    // whole row is masked so far)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = m[h2];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h2], sc[4 * j + 2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[h2] - mx);
      m[h2] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          const float p = sc[i] > NEG_INF / 2 ? exp2f(sc[i] - mx) : 0.f;
          sc[i] = p;
          sum += p;
          o[i] *= corr;
        }
      l[h2] = corr * l[h2] + sum;
    }

    // O += P V: P from registers as hi + lo bf16 (the accumulator's columns
    // 16kk .. 16kk + 15 are depth slice kk's A fragment; one bf16 alone
    // misses the 2^-8 limit where a few large terms of a row cancel), V
    // MN-major
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) tc::split_bf16x2(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);
    tc::fence_acc(o);
    tc::fence_regs(ph);
    tc::fence_regs(pl);
    tc::mbar_wait(v_full + 8 * s, parity);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      tc::WgmmaRS<128, true>::run(o, &ph[4 * kk], mnmajor(vt, kk));
      tc::WgmmaRS<128, true>::run(o, &pl[4 * kk], mnmajor(vt, kk));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(o);
    tc::fence_regs(ph);
    tc::fence_regs(pl);
    tc::mbar_arrive(empty + 8 * s);
  }

  // out = O / l (0 for a row that saw no key), lse = m ln 2 + ln l (NEG_INF then)
  bf16* op = out + (size_t)bh * sq * TC_HD;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row + 8 * h2;
    if (r >= sq) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)r * TC_HD + 8 * j + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * h2] * inv, o[4 * j + 2 * h2 + 1] * inv);
    if (lane % 4 == 0) lse[(size_t)bh * sq + r] = lt > 0.f ? m[h2] * LN2 + logf(lt) : NEG_INF;
  }
}

// dq. Shared memory: Q and dO (128 rows each, loaded once), then per stage
// the K tile and the V tile (DQ_BK rows each), then per stage the kv tile's
// segment ids, then the mbarriers q_full, full[], empty[]. Kv tiles of 64:
// each consumer's dQ (64 registers), S and dP (32 each) and dS's hi + lo
// fragments (16 each) fit its 240 registers; at 128, S and dP alone would
// take 128.
constexpr int DQ_BK = 64;
constexpr int DQ_STAGES = 4;
constexpr uint32_t KVTILE = 2 * BOX;          // DQ_BK rows x hd 128: its two hd chunks
constexpr uint32_t DQ_SEG = 2 * TILE128 + DQ_STAGES * 2 * KVTILE;
constexpr uint32_t DQ_BARS = DQ_SEG + DQ_STAGES * DQ_BK * 4;
constexpr int DQ_SMEM = DQ_BARS + 8 * (1 + 2 * DQ_STAGES) + 1024;

// One block per (head, q tile of 128 rows, batch row): the last q tiles,
// which see the most keys under the causal mask, first.
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, bf16* __restrict__ dq, int h, int sq, int skv,
                 float scale, int causal, int q_offset, int kv_offset) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* smem;
  const uint32_t base = tc_base(tc_smem, &smem);
  int* segk_s = reinterpret_cast<int*>(smem + DQ_SEG);
  const uint32_t q_full = base + DQ_BARS, full = q_full + 8, empty = full + 8 * DQ_STAGES;
  const int hh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * 128, bb = blockIdx.z;
  const int bh = bb * h + hh;
  const bool has_seg = seg_q != nullptr;
  // the kv tiles this q tile sees: under the causal mask, up to its last row
  int n_tiles = tc::cdiv(skv, DQ_BK);
  if (causal) {
    const int reach = q_offset + min(q0 + 128, sq) - 1 - kv_offset;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / DQ_BK + 1);
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      tc::mbar_init(full + 8 * s, 1 + 32);  // the TMA bytes and the producer warp's ids
      tc::mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp; lane 0 issues the TMA loads, every lane writes ids
    tc::setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != PRODUCER_WARP || n_tiles == 0) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tc::mbar_expect_tx(q_full, 2 * TILE128);
      load_tile128<false>(base, &q_map, q_full, q0, bh);
      load_tile128<false>(base + TILE128, &do_map, q_full, q0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % DQ_STAGES, k0 = it * DQ_BK;
      tc::mbar_wait(empty + 8 * s, ((it / DQ_STAGES) & 1) ^ 1);  // the first round passes
      const uint32_t kt = base + 2 * TILE128 + s * 2 * KVTILE;
      if (lane == 0) {
        tc::mbar_expect_tx(full + 8 * s, 2 * KVTILE);
        for (int dc = 0; dc < 2; ++dc) {
          tc::tma_load_3d(kt + dc * BOX, &k_map, full + 8 * s, 64 * dc, k0, bh);
          tc::tma_load_3d(kt + KVTILE + dc * BOX, &v_map, full + 8 * s, 64 * dc, k0, bh);
        }
      }
      // the tile's segment ids: 0 (pad) past skv, 1 everywhere without segments
      for (int c = lane; c < DQ_BK; c += 32) {
        const int kp = k0 + c;
        segk_s[s * DQ_BK + c] = kp >= skv ? 0 : has_seg ? seg_kv[(size_t)bb * skv + kp] : 1;
      }
      tc::mbar_arrive(full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread rows
  // row and row + 8, columns (kv rows of the tile) col + 8j + e. A row's
  // lse, delta and segment id stay in registers; rows past sq get lse
  // NEG_INF (p = 0), delta 0 and segment 0.
  tc::setmaxnreg_inc<240>();
  const int lane = threadIdx.x % 32;
  const int row = q0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  int segq[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    const bool in = r < sq;
    segq[h2] = !in ? 0 : has_seg ? seg_q[(size_t)bb * sq + r] : 1;
    const float lv = in ? lse[(size_t)bh * sq + r] : NEG_INF;
    // P = 2^(x - lse log2 e); a row that saw no key gets 2^-inf = 0
    l2[h2] = lv > NEG_INF / 2 ? lv * LOG2E : INFINITY;
    dl[h2] = in ? delta[(size_t)bh * sq + r] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  // the last q position of this warpgroup's rows (tiles past it are hidden
  // from all of them under the causal mask), and whether it has rows at all
  const int wg_last = q_offset + min(q0 + 64 * wg + 64, sq) - 1;
  const bool wg_live = q0 + 64 * wg < sq;
  float dqa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
  if (n_tiles > 0) tc::mbar_wait(q_full, 0);
  const uint32_t qt = base, dot = base + TILE128;
  // registers a wgmma reads are pinned before each wgmma.fence (as in the forward)

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % DQ_STAGES, k0 = it * DQ_BK;
    const uint32_t kt = base + 2 * TILE128 + s * 2 * KVTILE, vt = kt + KVTILE;
    tc::mbar_wait(full + 8 * s, (it / DQ_STAGES) & 1);
    if (!wg_live || (causal && wg_last < kv_offset + k0)) {
      tc::mbar_arrive(empty + 8 * s);  // every score of the tile is hidden from these rows
      continue;
    }

    // S = Q K^T and dP = dO V^T: 64 x 64 each, depth hd, all K-major
    float sc[32], dp[32];
    tc::fence_acc(sc);
    tc::fence_acc(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::WgmmaSS<DQ_BK, false, false>::run(
          sc, kmajor(qt, wg, kk), tc::operand_desc<false>(kt + (kk / 4) * BOX, kk % 4), kk);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::WgmmaSS<DQ_BK, false, false>::run(
          dp, kmajor(dot, wg, kk), tc::operand_desc<false>(vt + (kk / 4) * BOX, kk % 4), kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(sc);
    tc::fence_acc(dp);

    // dS = P (dP - delta), P = 2^(x - lse log2 e); masks only where they can
    // hide a score: past skv, with segments, and on tiles the causal
    // diagonal crosses for this warpgroup's rows
    const int* sk = segk_s + s * DQ_BK;
    const bool masked = has_seg || k0 + DQ_BK > skv ||
                        (causal && q_offset + q0 + 64 * wg < kv_offset + k0 + DQ_BK - 1);
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + 8 * j + e;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * j + 2 * h2 + e;
          float p = exp2f(sc[i] * sl2 - l2[h2]);
          if (masked) {
            const int id = sk[c];
            const bool ok = id != 0 && id == segq[h2] &&
                            (!causal || q_offset + row + 8 * h2 >= kv_offset + k0 + c);
            if (!ok) p = 0.f;
          }
          sc[i] = p * (dp[i] - dl[h2]);
        }
      }

    // dQ += dS K: dS from registers as hi + lo bf16 (as in the forward),
    // depth the tile's kv rows, K MN-major (its two hd chunks one box apart)
    uint32_t dh[16], dlo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) tc::split_bf16x2(sc[2 * i], sc[2 * i + 1], dh[i], dlo[i]);
    tc::fence_acc(dqa);
    tc::fence_regs(dh);
    tc::fence_regs(dlo);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      const uint64_t b = tc::operand_desc<true>(kt, kk);
      tc::WgmmaRS<128, true>::run(dqa, &dh[4 * kk], b);
      tc::WgmmaRS<128, true>::run(dqa, &dlo[4 * kk], b);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(dqa);
    tc::fence_regs(dh);
    tc::fence_regs(dlo);
    tc::mbar_arrive(empty + 8 * s);
  }

  // dQ carries the softmax scale here (the SIMT kernel carries it in q);
  // rows that saw no key store 0
  bf16* dqp = dq + (size_t)bh * sq * TC_HD;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row + 8 * h2;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = 4 * j + 2 * h2;
      *reinterpret_cast<__nv_bfloat162*>(dqp + (size_t)r * TC_HD + 8 * j + col) =
          __floats2bfloat162_rn(scale * dqa[i], scale * dqa[i + 1]);
    }
  }
}

// dk/dv. Shared memory: K and V (128 rows each, loaded once), then per stage
// the Q tile and the dO tile (DKV_BQ rows each), then per stage the q tile's
// lse, delta and segment ids, then the mbarriers kv_full, full[], empty[].
// A q tile of 32 rows: with 64, each consumer's dK and dV (128 registers),
// S^T and dP^T (64) and their hi + lo fragments did not fit the 240
// registers a consumer gets (ptxas spilled); at 32 S^T and dP^T take 16
// each.
constexpr int DKV_BQ = 32;
constexpr int DKV_STAGES = 4;
constexpr uint32_t QBOX = DKV_BQ * 128;       // a box of DKV_BQ rows x 64 hd: 4 KB
constexpr uint32_t QTILE = 2 * QBOX;          // DKV_BQ rows x hd 128
constexpr uint32_t DKV_VEC = 2 * TILE128 + DKV_STAGES * 2 * QTILE;
constexpr uint32_t DKV_BARS = DKV_VEC + DKV_STAGES * 3 * DKV_BQ * 4;
constexpr int DKV_SMEM = DKV_BARS + 8 * (1 + 2 * DKV_STAGES) + 1024;

// The first q tile that kv rows from k0 on can see under the causal mask:
// q tiles become visible as they go down.
__device__ __forceinline__ int first_visible_q_tile(int k0, int sq, int q_offset, int kv_offset) {
  if (q_offset + sq - 1 < kv_offset + k0) return tc::cdiv(sq, DKV_BQ);
  const int need = kv_offset + k0 - q_offset - (DKV_BQ - 1);  // the tile's last row reaches k0
  return need <= 0 ? 0 : tc::cdiv(need, DKV_BQ);
}

// One block per (head, kv tile of 128 rows, batch row): the first kv tiles,
// which see the most queries under the causal mask, first.
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int h, int sq, int skv, float scale, int causal, int q_offset, int kv_offset) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* smem;
  const uint32_t base = tc_base(tc_smem, &smem);
  float* vec_s = reinterpret_cast<float*>(smem + DKV_VEC);
  const uint32_t kv_full = base + DKV_BARS, full = kv_full + 8, empty = full + 8 * DKV_STAGES;
  const int hh = blockIdx.x, k0 = blockIdx.y * 128, bb = blockIdx.z;
  const int bh = bb * h + hh;
  const bool has_seg = seg_q != nullptr;
  const int first = causal ? first_visible_q_tile(k0, sq, q_offset, kv_offset) : 0;
  const int n_tiles = max(0, tc::cdiv(sq, DKV_BQ) - first);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    tc::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      tc::mbar_init(full + 8 * s, 1 + 32);  // the TMA bytes and the producer warp's rows
      tc::mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one warp; lane 0 issues the TMA loads, lane i writes the q
    // tile's row i lse, delta and segment id
    tc::setmaxnreg_dec<24>();
    if (threadIdx.x / 32 != PRODUCER_WARP || n_tiles == 0) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tc::mbar_expect_tx(kv_full, 2 * TILE128);
      load_tile128<false>(base, &k_map, kv_full, k0, bh);
      load_tile128<false>(base + TILE128, &v_map, kv_full, k0, bh);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % DKV_STAGES, q0 = (first + it) * DKV_BQ;
      tc::mbar_wait(empty + 8 * s, ((it / DKV_STAGES) & 1) ^ 1);  // the first round passes
      const uint32_t qt = base + 2 * TILE128 + s * 2 * QTILE;
      if (lane == 0) {
        tc::mbar_expect_tx(full + 8 * s, 2 * QTILE);
        for (int dc = 0; dc < 2; ++dc) {
          tc::tma_load_3d(qt + dc * QBOX, &q_map, full + 8 * s, 64 * dc, q0, bh);
          tc::tma_load_3d(qt + QTILE + dc * QBOX, &do_map, full + 8 * s, 64 * dc, q0, bh);
        }
      }
      // rows past sq: lse NEG_INF (p = 0), delta 0, segment 0 (pad)
      float* vs = vec_s + s * 3 * DKV_BQ;
      const int qp = q0 + lane;
      const bool in = qp < sq;
      vs[lane] = in ? lse[(size_t)bh * sq + qp] : NEG_INF;
      vs[DKV_BQ + lane] = in ? delta[(size_t)bh * sq + qp] : 0.f;
      reinterpret_cast<int*>(vs)[2 * DKV_BQ + lane] =
          !in ? 0 : has_seg ? seg_q[(size_t)bb * sq + qp] : 1;
      tc::mbar_arrive(full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns kv rows k0 + 64 wg .. + 63; this thread rows
  // krow and krow + 8, columns (q rows of the tile) col + 8j + e
  tc::setmaxnreg_inc<240>();
  const int lane = threadIdx.x % 32;
  const int krow = k0 + 64 * wg + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  int segk[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = krow + 8 * h2;
    segk[h2] = r >= skv ? 0 : has_seg ? seg_kv[(size_t)bb * skv + r] : 1;
  }
  const float sl2 = scale * LOG2E;
  float dka[64], dva[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dka[i] = dva[i] = 0.f;
  if (n_tiles > 0) tc::mbar_wait(kv_full, 0);
  const uint32_t kt = base, vt = base + TILE128;
  // registers a wgmma reads are pinned before each wgmma.fence (as in the forward)

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % DKV_STAGES, q0 = (first + it) * DKV_BQ;
    const uint32_t qt = base + 2 * TILE128 + s * 2 * QTILE, dot = qt + QTILE;

    // S^T = K Q^T and dP^T = V dO^T: 64 x 32 each, depth hd, all K-major
    float st[16], dpt[16];
    tc::mbar_wait(full + 8 * s, (it / DKV_STAGES) & 1);
    tc::fence_acc(st);
    tc::fence_acc(dpt);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::WgmmaSS<DKV_BQ, false, false>::run(
          st, kmajor(kt, wg, kk), tc::operand_desc<false>(qt + (kk / 4) * QBOX, kk % 4), kk);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tc::WgmmaSS<DKV_BQ, false, false>::run(
          dpt, kmajor(vt, wg, kk), tc::operand_desc<false>(dot + (kk / 4) * QBOX, kk % 4),
          kk);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(st);
    tc::fence_acc(dpt);

    // P^T = 2^(x - lse log2 e) (0 on rows that saw no key: lse NEG_INF gives
    // 2^-inf) and dS^T = P^T (dP^T - delta), the q row's lse and delta by
    // column; masks as in the forward
    const float* vs = vec_s + s * 3 * DKV_BQ;
    const int* sqs = reinterpret_cast<const int*>(vs) + 2 * DKV_BQ;
    const bool masked = has_seg || (causal && q_offset + q0 < kv_offset + k0 + 64 * wg + 63);
#pragma unroll
    for (int j = 0; j < DKV_BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col + 8 * j + e;
        const float lv = vs[c], dl = vs[DKV_BQ + c];
        const float l2 = lv > NEG_INF / 2 ? lv * LOG2E : INFINITY;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 4 * j + 2 * h2 + e;
          float p = exp2f(st[i] * sl2 - l2);
          if (masked) {
            const int id = sqs[c];
            const bool ok = segk[h2] != 0 && id == segk[h2] &&
                            (!causal || q_offset + q0 + c >= kv_offset + krow + 8 * h2);
            if (!ok) p = 0.f;
          }
          st[i] = p;
          dpt[i] = p * (dpt[i] - dl);
        }
      }

    // dV += P^T dO and dK += dS^T Q: A from registers as hi + lo bf16 (as in
    // the forward), depth the tile's q rows, dO and Q MN-major (their two hd
    // chunks one QBOX apart)
    uint32_t ph[8], pl[8], dh[8], dl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tc::split_bf16x2(st[2 * i], st[2 * i + 1], ph[i], pl[i]);
      tc::split_bf16x2(dpt[2 * i], dpt[2 * i + 1], dh[i], dl[i]);
    }
    tc::fence_acc(dva);
    tc::fence_acc(dka);
    tc::fence_regs(ph);
    tc::fence_regs(pl);
    tc::fence_regs(dh);
    tc::fence_regs(dl);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      const uint64_t b = tc::operand_desc<true>(dot, kk, QBOX);
      tc::WgmmaRS<128, true>::run(dva, &ph[4 * kk], b);
      tc::WgmmaRS<128, true>::run(dva, &pl[4 * kk], b);
    }
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      const uint64_t b = tc::operand_desc<true>(qt, kk, QBOX);
      tc::WgmmaRS<128, true>::run(dka, &dh[4 * kk], b);
      tc::WgmmaRS<128, true>::run(dka, &dl[4 * kk], b);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(dva);
    tc::fence_acc(dka);
    tc::fence_regs(ph);
    tc::fence_regs(pl);
    tc::fence_regs(dh);
    tc::fence_regs(dl);
    tc::mbar_arrive(empty + 8 * s);
  }

  // dK carries the softmax scale here (the SIMT kernel carries it in q)
  const size_t koff = (size_t)bh * skv * TC_HD;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = krow + 8 * h2;
    if (r >= skv) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const size_t at = koff + (size_t)r * TC_HD + 8 * j + col;
      const int i = 4 * j + 2 * h2;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(scale * dka[i], scale * dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int HD> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * 64 * (HD + 1) + BQ * LDS + 3 * BQ) + sizeof(int) * (BQ + BK);
}
template <int HD> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (HD + 1) + BQ * LDS + 2 * BQ) + sizeof(int) * (BQ + BK);
}
template <int HD> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * BQ * LDS + 2 * BQ) + sizeof(int) * (BQ + BK);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  // above 48 KB a block's dynamic shared memory must be opted into
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                       const int* seg_kv, void* out, float* lse, int b, int h, int h_kv, int sq,
                       int skv, float scale, int causal, int q_offset, int kv_offset,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = prepare(fwd_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q,
      seg_kv, static_cast<T*>(out), lse, h, h_kv, sq, skv, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* seg_q, const int* seg_kv,
                      void* dq, int b, int h, int sq, int skv, float scale, int causal,
                      int q_offset, int kv_offset, cudaStream_t stream) {
  const size_t smem = dq_smem<HD>();
  cudaError_t err = prepare(bwd_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  bwd_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg_q, seg_kv, static_cast<T*>(dq), h, sq, skv,
      scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* seg_q,
                       const int* seg_kv, void* dk, void* dv, int b, int h, int sq, int skv,
                       float scale, int causal, int q_offset, int kv_offset,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem<HD>();
  cudaError_t err = prepare(bwd_dkv_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((skv + BK - 1) / BK, h, b);
  bwd_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg_q, seg_kv, static_cast<T*>(dk),
      static_cast<T*>(dv), h, sq, skv, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}


template <typename Kernel>
cudaError_t prepare_tc(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, const int* seg_q,
                          const int* seg_kv, void* out, float* lse, int b, int h, int h_kv,
                          int sq, int skv, float scale, int causal, int q_offset, int kv_offset,
                          cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tc::make_map_3d(&q_map, q, TC_HD, sq, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&k_map, k, TC_HD, skv, b * h_kv);
  if (err == cudaSuccess) err = tc::make_map_3d(&v_map, v, TC_HD, skv, b * h_kv);
  if (err == cudaSuccess) err = prepare_tc(fwd_tc_kernel, FWD_SMEM);
  if (err != cudaSuccess) return err;
  fwd_tc_kernel<<<dim3(h, tc::cdiv(sq, 128), b), TC_THREADS, FWD_SMEM, stream>>>(
      q_map, k_map, v_map, seg_q, seg_kv, static_cast<bf16*>(out), lse, h, h_kv, sq, skv, scale,
      causal, q_offset, kv_offset);
  return cudaGetLastError();
}

cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* seg_q,
                         const int* seg_kv, void* dq, int b, int h, int sq, int skv, float scale,
                         int causal, int q_offset, int kv_offset, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = tc::make_map_3d(&q_map, q, TC_HD, sq, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&k_map, k, TC_HD, skv, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&v_map, v, TC_HD, skv, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&do_map, dout, TC_HD, sq, b * h);
  if (err == cudaSuccess) err = prepare_tc(bwd_dq_tc_kernel, DQ_SMEM);
  if (err != cudaSuccess) return err;
  bwd_dq_tc_kernel<<<dim3(h, tc::cdiv(sq, 128), b), TC_THREADS, DQ_SMEM, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, seg_q, seg_kv, static_cast<bf16*>(dq), h, sq,
      skv, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const int* seg_q,
                          const int* seg_kv, void* dk, void* dv, int b, int h, int sq, int skv,
                          float scale, int causal, int q_offset, int kv_offset,
                          cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = tc::make_map_3d(&q_map, q, TC_HD, sq, b * h, DKV_BQ);
  if (err == cudaSuccess) err = tc::make_map_3d(&k_map, k, TC_HD, skv, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&v_map, v, TC_HD, skv, b * h);
  if (err == cudaSuccess) err = tc::make_map_3d(&do_map, dout, TC_HD, sq, b * h, DKV_BQ);
  if (err == cudaSuccess) err = prepare_tc(bwd_dkv_tc_kernel, DKV_SMEM);
  if (err != cudaSuccess) return err;
  bwd_dkv_tc_kernel<<<dim3(h, tc::cdiv(skv, 128), b), TC_THREADS, DKV_SMEM, stream>>>(
      q_map, k_map, v_map, do_map, lse, delta, seg_q, seg_kv, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, sq, skv, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32. head_dim: 128 (every LLaMA preset's). The SIMT
// kernels take float32 only: in bf16 every pass runs on the tensor cores
// (lpt_flash_fwd_tc, lpt_flash_bwd_dq_tc, lpt_flash_bwd_dkv_tc).
#define LPT_DISPATCH_F32(DTYPE, HD, CALL)                                   \
  do {                                                                      \
    if ((DTYPE) == 0 && (HD) == 128) return (int)CALL(float, 128);          \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" {

int lpt_flash_fwd(const void* q, const void* k, const void* v, const int* seg_q,
                  const int* seg_kv, void* out, float* lse, int b, int h, int h_kv, int sq,
                  int skv, int hd, int dtype, float scale, int causal, int q_offset,
                  int kv_offset, void* stream) {
#define CALL(T, HD)                                                                   \
  launch_fwd<T, HD>(q, k, v, seg_q, seg_kv, out, lse, b, h, h_kv, sq, skv, scale, causal, \
                    q_offset, kv_offset, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH_F32(dtype, hd, CALL);
#undef CALL
}

int lpt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* seg_q, const int* seg_kv,
                     void* dq, int b, int h, int sq, int skv, int hd, int dtype, float scale,
                     int causal, int q_offset, int kv_offset, void* stream) {
#define CALL(T, HD)                                                                      \
  launch_dq<T, HD>(q, k, v, dout, lse, delta, seg_q, seg_kv, dq, b, h, sq, skv, scale, causal, \
                   q_offset, kv_offset, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH_F32(dtype, hd, CALL);
#undef CALL
}

int lpt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* seg_q,
                      const int* seg_kv, void* dk, void* dv, int b, int h, int sq, int skv,
                      int hd, int dtype, float scale, int causal, int q_offset, int kv_offset,
                      void* stream) {
#define CALL(T, HD)                                                                        \
  launch_dkv<T, HD>(q, k, v, dout, lse, delta, seg_q, seg_kv, dk, dv, b, h, sq, skv, scale, \
                    causal, q_offset, kv_offset, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH_F32(dtype, hd, CALL);
#undef CALL
}

// bf16 with head_dim 128 on the tensor cores; every pointer 16-byte aligned.
int lpt_flash_fwd_tc(const void* q, const void* k, const void* v, const int* seg_q,
                     const int* seg_kv, void* out, float* lse, int b, int h, int h_kv, int sq,
                     int skv, float scale, int causal, int q_offset, int kv_offset,
                     void* stream) {
  return (int)launch_fwd_tc(q, k, v, seg_q, seg_kv, out, lse, b, h, h_kv, sq, skv, scale, causal,
                            q_offset, kv_offset, static_cast<cudaStream_t>(stream));
}

int lpt_flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, const int* seg_q, const int* seg_kv,
                        void* dq, int b, int h, int sq, int skv, float scale, int causal,
                        int q_offset, int kv_offset, void* stream) {
  return (int)launch_dq_tc(q, k, v, dout, lse, delta, seg_q, seg_kv, dq, b, h, sq, skv, scale,
                           causal, q_offset, kv_offset, static_cast<cudaStream_t>(stream));
}

int lpt_flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* seg_q,
                         const int* seg_kv, void* dk, void* dv, int b, int h, int sq, int skv,
                         float scale, int causal, int q_offset, int kv_offset, void* stream) {
  return (int)launch_dkv_tc(q, k, v, dout, lse, delta, seg_q, seg_kv, dk, dv, b, h, sq, skv,
                            scale, causal, q_offset, kv_offset,
                            static_cast<cudaStream_t>(stream));
}

const char* lpt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
