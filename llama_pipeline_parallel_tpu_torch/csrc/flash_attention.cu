// Flash attention (FlashAttention-2 schedule) for Hopper: forward, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of llama_pipeline_parallel_tpu/ops/flash_attention.py:
//   fwd_kernel     <- _fwd_kernel      (pallas_call in _fwd)
//   bwd_dq_kernel  <- _bwd_dq_kernel   (first pallas_call in _bwd)
//   bwd_dkv_kernel <- _bwd_dkv_kernel  (second pallas_call in _bwd)
//
// What they compute is the TPU kernels' contract, not their block structure.
// The TPU walks a sequential grid axis and carries the softmax state in VMEM
// scratch from one grid step to the next; here one thread block owns one
// (batch, head, q tile) and loops over the KV tiles itself (forward, dq), or
// owns one (batch, head, kv tile) and loops over the q tiles (dk/dv). Every
// output element is written by exactly one block, so no atomics are needed.
//
// Semantics kept from the reference:
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
// rate. This first version does its products with scalar fp32 FMAs out of
// shared memory, far below that rate: each thread owns a 4 x (N / 16)
// register micro-tile, so every shared-memory load feeds 2 to 4 FMAs, and the
// tiles are stored with one float of row padding so that the loads of a warp
// fall on distinct banks. Tensor cores (wgmma), TMA and pipelined loads are the
// next step and change none of the semantics above.
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

namespace {

constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // kv rows per tile
constexpr int NT = 256;          // threads per block, seen as a 16 x 16 grid
constexpr int LDS = BK + 1;      // row stride of a [BQ, BK] score tile in shared memory
constexpr float NEG_INF = -1e30f;

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim: 128 (every LLaMA preset's).
#define LPT_DISPATCH(DTYPE, HD, CALL)                                       \
  do {                                                                      \
    if ((DTYPE) == 0 && (HD) == 128) return (int)CALL(float, 128);          \
    if ((DTYPE) == 1 && (HD) == 128) return (int)CALL(__nv_bfloat16, 128);  \
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
  LPT_DISPATCH(dtype, hd, CALL);
#undef CALL
}

int lpt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* seg_q, const int* seg_kv,
                     void* dq, int b, int h, int sq, int skv, int hd, int dtype, float scale,
                     int causal, int q_offset, int kv_offset, void* stream) {
#define CALL(T, HD)                                                                      \
  launch_dq<T, HD>(q, k, v, dout, lse, delta, seg_q, seg_kv, dq, b, h, sq, skv, scale, causal, \
                   q_offset, kv_offset, static_cast<cudaStream_t>(stream))
  LPT_DISPATCH(dtype, hd, CALL);
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
  LPT_DISPATCH(dtype, hd, CALL);
#undef CALL
}

const char* lpt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
