// The bare tensor-core mainloop of tc_tile.cuh with a plain fp32 store: a
// library for tests only (nothing in the package loads it), which holds the
// TMA ring and the wgmma operand descriptors to torch.matmul for each operand
// layout pair of the CE backward products before any epilogue is involved:
//   grad  h @ W_c    A K-major,  B MN-major
//   dh    g @ W_c^T  A K-major,  B K-major
//   dW    h^T @ g    A MN-major, B MN-major
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.

#include "tc_tile.cuh"

namespace {

using namespace lpt;

struct MatmulStore {  // c[i, j] = acc in fp32, each element masked
  float* __restrict__ c;
  int m, n;
  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int row, int col) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = col + 8 * j + e;
          if (cc < n) c[(size_t)r * n + cc] = acc[4 * j + 2 * h + e];
        }
      }
    }
  }
};

template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(tc::THREADS, 1)
tc_matmul_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, int m, int n, int k, MatmulStore out) {
  tc::tile_product<A_MN, B_MN>(a_map, b_map, m, n, k, out);
}

template <bool A_MN, bool B_MN>
cudaError_t launch_matmul_tc(const void* a, const void* b, float* c, int m, int n, int k,
                             cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  cudaError_t err = A_MN ? tc::make_map(&a_map, a, m, k, m) : tc::make_map(&a_map, a, k, m, k);
  if (err == cudaSuccess)
    err = B_MN ? tc::make_map(&b_map, b, n, k, n) : tc::make_map(&b_map, b, k, n, k);
  if (err != cudaSuccess) return err;
  return tc::launch(tc_matmul_kernel<A_MN, B_MN>, m, n, stream, a_map, b_map, m, n, k,
                    MatmulStore{c, m, n});
}

}  // namespace

extern "C" {

// c [m, n] = A B^T with A [m, k] (a_mn = 0) or [k, m] (a_mn = 1) and B [n, k]
// (b_mn = 0) or [k, n] (b_mn = 1), bf16, contiguous, rows multiples of 16
// bytes; only the three layout pairs above (a_mn b_mn = 0 1, 0 0, 1 1).
int lpt_tc_matmul(const void* a, const void* b, float* c, int m, int n, int k, int a_mn,
                  int b_mn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_mn && b_mn) return launch_matmul_tc<true, true>(a, b, c, m, n, k, st);
  if (a_mn) return cudaErrorInvalidValue;
  if (b_mn) return launch_matmul_tc<false, true>(a, b, c, m, n, k, st);
  return launch_matmul_tc<false, false>(a, b, c, m, n, k, st);
}

const char* lpt_tc_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
