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
// Bound by bytes: 8 bytes of traffic per σ, a few hundred nanoseconds at the
// sizes TT-SVD gives it, so the launch and the kernel's latency are all
// there is.  The block is shaped to n, and the values stay in registers:
//   * n <= 1,024: one warp a row, several rows a block; lane l holds the
//     values [l C, l C + C) (C <= 32, a power of two), sums them from its
//     end, and a shuffle scan of the lane totals gives each lane the sum past
//     its values.  No shared memory and no __syncthreads.
//   * larger n: one block a row of ceil(n / 4) threads rounded to warps (at
//     most 1,024; longer rows go in chunks of 4,096, the last chunk first),
//     4 values a thread; the warp totals are exchanged once through shared
//     memory and each warp scans them itself.  (On an H100, 8 values a
//     thread took 2.58-2.91 us of device time at n = 1,025 and 2,816
//     where 4 take 2.38-2.62; PERF.md.)
// Values move 16 bytes a lane where a lane's run is whole and aligned.
// The first index under δ: each lane keeps its smallest hit, __ballot_sync
// picks the first lane with one (lanes hold increasing indices), and the
// block takes the smallest over its warps.  One call is one kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // warp route: one row per warp
constexpr int kBlockVPT = 4;      // block route: values per thread
constexpr int kMaxThreads = 1024;

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

// The smallest hit of the warp, each lane's ``mine`` (n: none) over
// increasing index ranges.
__device__ __forceinline__ int warp_first_hit(int mine, int n) {
  const unsigned hits = __ballot_sync(kFull, mine < n);
  return hits ? __shfl_sync(kFull, mine, __ffs(hits) - 1) : n;
}

__device__ __forceinline__ int rank_of(int first, int n) {
  return min(max(first < n ? first + 1 : n, 1), n);
}

// x[i] = p[base + i] for i < V (zeros past n): 16-byte loads where the V
// values are whole and aligned, else one at a time.
template <int V>
__device__ __forceinline__ void load_values(const float* p, int base, int n,
                                            float (&x)[V]) {
  if constexpr (V % 4 == 0) {
    if (base + V <= n && (reinterpret_cast<uintptr_t>(p + base) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + base + i);
        x[i] = f.x;
        x[i + 1] = f.y;
        x[i + 2] = f.z;
        x[i + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = base + i < n ? p[base + i] : 0.f;
}

// p[base + i] = x[i] for base + i < n, as load_values reads.
template <int V>
__device__ __forceinline__ void store_values(float* p, int base, int n,
                                             const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
    if (base + V <= n && (reinterpret_cast<uintptr_t>(p + base) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(p + base + i) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (base + i < n) p[base + i] = x[i];
}

// Sums the thread's V values [base, base + V) of the row from their end:
// r[i] = σ²[base + i] + ... + σ²[base + V - 1] (zeros past n); returns r[0].
template <int V>
__device__ __forceinline__ float local_suffix(const float* srow, int base,
                                              int n, float (&r)[V]) {
  float x[V];
  load_values<V>(srow, base, n, x);
  float run = 0.f;
#pragma unroll
  for (int i = V - 1; i >= 0; --i) {
    run += x[i] * x[i];
    r[i] = run;
  }
  return run;
}

// Writes the tails of [base, base + V) over ``carry`` (the sum past them)
// and returns the smallest index with a tail under δ (n: none).
template <int V>
__device__ __forceinline__ int write_tails(float* trow, int base, int n,
                                           float carry, const float (&r)[V],
                                           float delta) {
  float t[V];
  int mine = n;
#pragma unroll
  for (int i = V - 1; i >= 0; --i) {
    t[i] = sqrtf(carry + r[i]);
    if (base + i < n && t[i] < delta) mine = base + i;
  }
  store_values<V>(trow, base, n, t);
  return mine;
}

template <int C>
__global__ void __launch_bounds__(32 * kRowsPerBlock) truncate_warp_kernel(
    const float* __restrict__ s, const float* __restrict__ delta_vec,
    int delta_stride, float delta_scalar, float* __restrict__ tail,
    int* __restrict__ rank, int rows, int n) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp
  const float* srow = s + (size_t)row * n;
  const float delta =
      delta_vec ? delta_vec[(size_t)row * delta_stride] : delta_scalar;
  const int base = lane * C;
  float r[C];
  const float total = local_suffix<C>(srow, base, n, r);
  float carry = __shfl_down_sync(kFull, warp_suffix_sum(total, lane), 1);
  if (lane == 31) carry = 0.f;
  const int mine =
      write_tails<C>(tail + (size_t)row * n, base, n, carry, r, delta);
  const int first = warp_first_hit(mine, n);
  if (lane == 0) rank[row] = rank_of(first, n);
}

__global__ void __launch_bounds__(kMaxThreads, 1) truncate_block_kernel(
    const float* __restrict__ s, const float* __restrict__ delta_vec,
    int delta_stride, float delta_scalar, float* __restrict__ tail,
    int* __restrict__ rank, int n) {
  __shared__ float warp_tot[32];
  __shared__ int warp_hit[32];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nw = blockDim.x / 32;
  const int row = blockIdx.x;
  const float* srow = s + (size_t)row * n;
  float* trow = tail + (size_t)row * n;
  const float delta =
      delta_vec ? delta_vec[(size_t)row * delta_stride] : delta_scalar;
  const int chunk = kBlockVPT * blockDim.x;

  float carry = 0.f;  // σ² past the chunk (the same in every thread)
  int first = n;
  for (int c0 = (n - 1) / chunk * chunk; c0 >= 0; c0 -= chunk) {
    const int base = c0 + tid * kBlockVPT;
    float r[kBlockVPT];
    const float total = local_suffix<kBlockVPT>(srow, base, n, r);
    const float incl = warp_suffix_sum(total, lane);
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) excl = 0.f;
    if (lane == 0) warp_tot[warp] = incl;
    __syncthreads();
    // each warp scans the warp totals itself: lane w gets warps w.. on
    const float wsuf =
        warp_suffix_sum(lane < nw ? warp_tot[lane] : 0.f, lane);
    const float after = __shfl_sync(kFull, wsuf, (warp + 1) % 32);
    const float chunk_total = __shfl_sync(kFull, wsuf, 0);
    const float past = carry + (warp + 1 < nw ? after : 0.f) + excl;
    const int mine = write_tails<kBlockVPT>(trow, base, n, past, r, delta);
    const int wfirst = warp_first_hit(mine, n);
    if (lane == 0) warp_hit[warp] = wfirst;
    __syncthreads();
    int hit = lane < nw ? warp_hit[lane] : n;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      hit = min(hit, __shfl_xor_sync(kFull, hit, off));
    if (hit < n) first = hit;  // chunks go last to first
    carry += chunk_total;
    if (c0 > 0) __syncthreads();  // the exchange is reused
  }
  if (tid == 0) rank[row] = rank_of(first, n);
}

template <int C>
void launch_warp(const float* s, const float* delta_vec, int delta_stride,
                 float delta_scalar, float* tail, int* rank, int rows, int n,
                 cudaStream_t stream) {
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  truncate_warp_kernel<C><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
      s, delta_vec, delta_stride, delta_scalar, tail, rank, rows, n);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// s (rows, n) f32 on the device; delta_vec f32 on the device, row r's δ at
// delta_vec[r * delta_stride] (stride 0: one δ for every row), or null to
// use delta_scalar; tail (rows, n) f32; rank (rows,) int32.  rows, n >= 1.
int frob_truncate(const float* s, const float* delta_vec, int delta_stride,
                  float delta_scalar, float* tail, int* rank, int rows, int n,
                  void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_lane = (n + 31) / 32;
  if (per_lane <= 1)
    launch_warp<1>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                   rows, n, st);
  else if (per_lane <= 2)
    launch_warp<2>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                   rows, n, st);
  else if (per_lane <= 4)
    launch_warp<4>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                   rows, n, st);
  else if (per_lane <= 8)
    launch_warp<8>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                   rows, n, st);
  else if (per_lane <= 16)
    launch_warp<16>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                    rows, n, st);
  else if (per_lane <= 32)
    launch_warp<32>(s, delta_vec, delta_stride, delta_scalar, tail, rank,
                    rows, n, st);
  else {
    const int warps = ((n + kBlockVPT - 1) / kBlockVPT + 31) / 32;
    const int threads = warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
    truncate_block_kernel<<<rows, threads, 0, st>>>(
        s, delta_vec, delta_stride, delta_scalar, tail, rank, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
