// Host-side AdamW for the offloaded-optimizer tier (optim/offload.py).
//
// The counterpart of DeepSpeedCPUAdam (the C++ op behind the reference's
// `offload_optimizer: device: cpu` config): fp32 master params + moments live
// in host DRAM; the card only ever holds the bf16 working copy. The kernel is
// a single fused pass (one read of g, one read/write of p/m/v each) --
// memory-bandwidth-bound -- parallelized across cores (`omp parallel for`)
// and vectorized within each (`simd`), like DeepSpeedCPUAdam's AVX+OpenMP
// loop. The caller sets the thread count (omp_set_num_threads through this
// library's OpenMP runtime). adamw_step and l2_norm_sq are the JAX package's
// csrc/host_adamw.cpp line for line: built with the same flags, both give the
// same bits; f32_to_bf16 adds a NaN rule (below).
//
// Bias correction matches optax.adamw's `scale_by_adam` (mhat = m/(1-b1^t))
// so the offloaded path is numerically interchangeable with the on-device
// optimizer; `step` is the 1-based step index.
//
// decoupled weight decay: p -= lr * (mhat / (sqrt(vhat) + eps) + wd * p)

#include <cmath>
#include <cstdint>

extern "C" {

void adamw_step(float* __restrict p,
                float* __restrict m,
                float* __restrict v,
                const float* __restrict g,
                int64_t n,
                float lr, float b1, float b2, float eps, float wd,
                int64_t step,
                float grad_scale) {
  const float bc1 = 1.0f - std::pow(b1, static_cast<float>(step));
  const float bc2 = 1.0f - std::pow(b2, static_cast<float>(step));
  const float one_m_b1 = 1.0f - b1;
  const float one_m_b2 = 1.0f - b2;

#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float gi = g[i] * grad_scale;
    const float mi = b1 * m[i] + one_m_b1 * gi;
    const float vi = b2 * v[i] + one_m_b2 * gi * gi;
    m[i] = mi;
    v[i] = vi;
    const float mhat = mi / bc1;
    const float vhat = vi / bc2;
    p[i] -= lr * (mhat / (std::sqrt(vhat) + eps) + wd * p[i]);
  }
}

// Squared L2 norm of a buffer (for host-side global-norm clipping).
double l2_norm_sq(const float* __restrict g, int64_t n) {
  double acc = 0.0;
#pragma omp parallel for simd reduction(+ : acc) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    acc += static_cast<double>(g[i]) * static_cast<double>(g[i]);
  }
  return acc;
}

// fp32 -> bf16 (round-to-nearest-even): builds the device working copy on
// the host so the H2D transfer moves HALF the bytes of an fp32 upload. A NaN
// becomes 0xFFFF, as torch's host cast gives it (rounding its bits would
// carry a NaN whose payload lies in the low 16 bits to an infinity).
void f32_to_bf16(const float* __restrict src, uint16_t* __restrict dst,
                 int64_t n) {
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x = bits[i];
    uint32_t rounding = 0x7FFFu + ((x >> 16) & 1u);
    uint16_t rounded = static_cast<uint16_t>((x + rounding) >> 16);
    dst[i] = (x & 0x7FFFFFFFu) > 0x7F800000u ? uint16_t(0xFFFFu) : rounded;
  }
}

}  // extern "C"
