// δ-truncation (the paper's TRUNCATION module) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas kernels of src/repro/kernels/frob_truncate/kernel.py:
//   frob_truncate          (_truncate_kernel, grid (1,))
//   frob_truncate_batched  (_truncate_kernel, grid (B,)), each row with its
//                          own δ.
// For each row of σ: tail norms t[i] = ||σ[i:]||_2 (a reverse inclusive scan
// of σ²), then the kept rank r = the smallest 1-indexed i with t[i] < δ, else
// n, clipped to [1, n].
//
// One block per row.  σ² goes to shared memory once; each of the 1024 threads
// sums one contiguous segment (from its end), warp shuffles scan the segment
// totals, and each thread then writes its segment's tails from its end with
// the totals of the segments after it as the carry.  The first index under δ
// is a block-wide atomicMin (the tails are non-increasing, so it is the
// reference's argmax of the mask).  Bound by bytes: 8 bytes of traffic per
// σ, a few hundred nanoseconds at the sizes TT-SVD gives it; the launch
// itself dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Reverse (suffix) inclusive sum across the 32 lanes: lane l gets the sum of
// lanes l..31.
__device__ __forceinline__ float warp_suffix_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) frob_truncate_kernel(
    const float* __restrict__ s, const float* __restrict__ delta_vec,
    float delta_scalar, float* __restrict__ tail, int* __restrict__ rank,
    int n) {
  extern __shared__ float sq[];            // n floats
  __shared__ float warp_tot[kWarps];
  __shared__ int first_hit;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const float* srow = s + (size_t)row * n;
  float* trow = tail + (size_t)row * n;
  const float delta = delta_vec ? delta_vec[row] : delta_scalar;

  for (int i = t; i < n; i += kThreads) {
    const float v = srow[i];
    sq[i] = v * v;
  }
  if (t == 0) first_hit = n;
  __syncthreads();

  const int seg = (n + kThreads - 1) / kThreads;
  const int lo = min(n, t * seg);
  const int hi = min(n, lo + seg);
  float total = 0.f;
  for (int i = hi - 1; i >= lo; --i) total += sq[i];

  // carry = sum of the segments after this thread's (exclusive suffix scan)
  const float incl = warp_suffix_sum(total, lane);
  float excl = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) excl = 0.f;
  if (lane == 0) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = warp_suffix_sum(warp_tot[lane], lane);
    __syncwarp();
    warp_tot[lane] = w;
  }
  __syncthreads();
  float run = excl + (warp + 1 < kWarps ? warp_tot[warp + 1] : 0.f);

  int mine = n;
  for (int i = hi - 1; i >= lo; --i) {
    run += sq[i];
    const float ti = sqrtf(run);
    trow[i] = ti;
    if (ti < delta) mine = i;
  }
  if (mine < n) atomicMin(&first_hit, mine);
  __syncthreads();
  if (t == 0) {
    int r = first_hit < n ? max(first_hit + 1, 1) : n;
    rank[row] = min(max(r, 1), n);
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

// s (rows, n) f32 on the device; delta_vec (rows,) f32 on the device, or null
// to use delta_scalar for every row; tail (rows, n) f32; rank (rows,) int32.
int frob_truncate(const float* s, const float* delta_vec, float delta_scalar,
                  float* tail, int* rank, int rows, int n, void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      frob_truncate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  frob_truncate_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      s, delta_vec, delta_scalar, tail, rank, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
