// Descending singular-value sort with its index vector (the paper's SORTING
// module) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/singular_sort/kernel.py:
//   bitonic_sort_desc          (_sort_kernel, grid (1,))
//   bitonic_sort_desc_batched  (_sort_kernel, grid (B,))
// Each row is padded to a power of two with -3.4e38 and sorted descending by
// a bitonic network; the index vector records where each value came from.
//
// One block per row, the whole row (keys and indices, 8 bytes per element)
// in shared memory: n <= 2,816 at full qwen1.5-0.5b width pads to 4,096, so
// 32 KB.  Unlike the TPU kernel, which compares values only, this one
// compares (σ, index) pairs: the order is total, so ties keep index order and
// the index vector equals a stable argsort(-σ).  Bound by the launch and the
// log²(n) barrier-separated stages, not by bytes (12 bytes per element).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.4e38f;

// true when (ka, ia) must come before (kb, ib) in the descending order
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__global__ void bitonic_sort_kernel(const float* __restrict__ s,
                                    float* __restrict__ out_s,
                                    int64_t* __restrict__ out_idx, int n,
                                    int n_pad) {
  extern __shared__ float smem[];
  float* key = smem;                                   // n_pad floats
  int* idx = reinterpret_cast<int*>(smem + n_pad);     // n_pad ints
  const size_t row = blockIdx.x;
  const float* srow = s + row * n;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    key[i] = i < n ? srow[i] : kNegInf;
    idx[i] = i;
  }
  __syncthreads();
  const int half = n_pad / 2;
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = 2 * t - (t & (j - 1));   // t-th index with bit j clear
        const int hi = lo + j;
        const bool desc = (lo & k) == 0;
        const float ka = key[lo], kb = key[hi];
        const int ia = idx[lo], ib = idx[hi];
        const bool hi_first = before(kb, ib, ka, ia);
        if (desc == hi_first) {
          key[lo] = kb; key[hi] = ka;
          idx[lo] = ib; idx[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out_s[row * n + i] = key[i];
    out_idx[row * n + i] = idx[i];
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int max_shared_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// s (rows, n) f32; out_s (rows, n) f32; out_idx (rows, n) int64; n_pad is
// the power of two >= n.
int singular_sort(const float* s, float* out_s, int64_t* out_idx, int rows,
                  int n, int n_pad, void* stream) {
  const size_t smem = (size_t)n_pad * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int threads = n_pad / 2;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  bitonic_sort_kernel<<<rows, threads, smem, (cudaStream_t)stream>>>(
      s, out_s, out_idx, n, n_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
