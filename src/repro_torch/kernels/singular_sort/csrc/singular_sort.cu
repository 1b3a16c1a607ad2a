// Descending singular-value sort with its index vector (the paper's SORTING
// module) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/singular_sort/kernel.py:
//   bitonic_sort_desc          (_sort_kernel, grid (1,))
//   bitonic_sort_desc_batched  (_sort_kernel, grid (B,))
// Each row is sorted descending by a bitonic network over n_pad positions
// (the power of two >= n, at least 32); the index vector records where each
// value came from.  One block per row.
//
// Unlike the TPU kernel, which compares values only, this one sorts
// (σ, index) pairs, packed into one 64-bit key: the high word is σ's bits
// mapped to an unsigned order (-0.0 read as +0.0, NaN below every number, as
// a stable argsort(-σ) places it), the low word the complement of the index.
// A larger key comes first, so the order is total, ties keep index order and
// the index vector equals a stable argsort(-σ).  Padding is key 0, below
// every real element.  The sorted σ are gathered from the input by the index
// vector, so their bits are the input's.
//
// What bounds it: one block does log2(n_pad)·(log2(n_pad)+1)/2 stages of
// compare-exchanges (78 at n_pad = 4,096), so the time is the stages' data
// movement and their barriers, not bytes (16 per element).  The design:
//   * Registers first.  Thread t holds keys t·E .. t·E + E - 1 (E = 8, 16
//     at n_pad = 16,384, n_pad / 32 below 256).  A stage whose partner
//     distance j is below E compares two of the thread's own registers;
//     j below 32·E pairs lanes of one warp (__shfl_xor_sync); only
//     j >= 32·E goes through shared memory, one barrier a stage (two
//     buffers alternate; one buffer and a second barrier where two do not
//     fit).  At n_pad = 4,096: 33 register, 35 shuffle and 10 barrier
//     stages (the one-stage-per-barrier network had 78).
//   * The flip form of the network: each merge of size k starts with a
//     stage pairing position i with i ^ (k - 1), then half-cleaners pair i
//     with i ^ j; every comparator puts the larger key at the lower
//     position, so no stage needs a direction, and padding (the smallest
//     key) never moves below position n.  So the block holds only
//     ceil(n / (32 E)) warps: positions past them are padding, and a
//     comparator with one there keeps the lower (real) key.  At n = 2,816:
//     11 warps instead of the 16 of n_pad = 4,096.
//   * No attribute call for shared memory up to 48 KB (n = 2,816 needs
//     45 KB); past it, the opt-in is set once per size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPad = 16384;             // the longest padded row
constexpr int kRegs = 8;                   // keys a thread holds, long rows
constexpr int kDefaultSmem = 48 * 1024;   // usable without an opt-in

// the sort key of (σ, index): larger = earlier in the descending order
__device__ __forceinline__ uint64_t make_key(float s, int i) {
  uint32_t b = __float_as_uint(s);
  uint32_t u;
  if ((b & 0x7fffffffu) > 0x7f800000u) {
    u = 0u;                                  // NaN: after every number
  } else {
    if ((b & 0x7fffffffu) == 0u) b = 0u;     // -0.0 ties with +0.0
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((uint64_t)u << 32) | (uint32_t)(~(uint32_t)i);
}

__device__ __forceinline__ int key_index(uint64_t k) {
  return (int)(~(uint32_t)k);
}

// the key this position keeps: the larger one when it is the pair's lower
// position in a descending region (or the upper in an ascending one)
__device__ __forceinline__ uint64_t keep(uint64_t mine, uint64_t other,
                                         bool larger) {
  return (larger == (mine > other)) ? mine : other;
}

// a compare-exchange of two of the thread's keys: the larger to lo
__device__ __forceinline__ void exchange(uint64_t& lo, uint64_t& hi) {
  const uint64_t a = lo, b = hi;
  lo = a > b ? a : b;
  hi = a > b ? b : a;
}

// A stage whose partner lane is lane ^ m: key e meets the partner's key e,
// or its key E - 1 - e in a flip stage.  lo: this thread keeps the larger.
template <int E, bool Flip>
__device__ __forceinline__ void shuffle_stage(uint64_t (&c)[E], int m,
                                              bool lo) {
  constexpr bool kPairs = Flip && E > 1;     // keys e and E - 1 - e swap
#pragma unroll
  for (int e = 0; e < (kPairs ? E / 2 : E); ++e) {
    const int f = kPairs ? E - 1 - e : e;
    const uint64_t a = __shfl_xor_sync(kFull, c[f], m);
    const uint64_t b = kPairs ? __shfl_xor_sync(kFull, c[e], m) : a;
    c[e] = keep(c[e], a, lo);
    if (kPairs) c[f] = keep(c[f], b, lo);
  }
}

// The same with the partner thread t ^ m in another warp, through shared
// memory b (key e of thread t at b[e * threads + t]); a partner past the
// block's threads holds padding, which the lower position keeps out.
template <int E, bool Flip>
__device__ __forceinline__ void shared_stage(uint64_t (&c)[E], uint64_t* b,
                                             int threads, int t, int m,
                                             bool lo) {
#pragma unroll
  for (int e = 0; e < E; ++e) b[e * threads + t] = c[e];
  __syncthreads();
  const int p = t ^ m;
  if (p < threads) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      c[e] = keep(c[e], b[(Flip ? E - 1 - e : e) * threads + p], lo);
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxPad / E < kMaxThreads ? kMaxPad / E
                                                            : kMaxThreads)
bitonic_sort_kernel(const float* __restrict__ s, float* __restrict__ out_s,
                    int64_t* __restrict__ out_idx, int n, int n_pad,
                    int two_buffers) {
  extern __shared__ uint64_t buf[];          // 1 or 2 x blockDim.x * E keys
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int threads = blockDim.x;            // ceil(n / (32 E)) warps
  const int held = threads * E;              // positions held; the rest pad
  const size_t row = blockIdx.x;
  const float* srow = s + row * n;
  const int base = t * E;
  uint64_t c[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base + e;
    c[e] = i < n ? make_key(srow[i], i) : 0ull;
  }
  // merges of up to E keys, inside the thread
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)              // flip: partner e ^ (k - 1)
      if ((e & (k - 1)) < k / 2) exchange(c[e], c[e ^ (k - 1)]);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & j)) exchange(c[e], c[e | j]);
  }
  // longer merges: a flip stage (partner position i ^ (k - 1)), then
  // half-cleaner stages (i ^ j), through shared memory, a shuffle or
  // registers by the partner's distance.  The thread's E keys share one
  // side: the lower (keeps the larger) when bit log2(k) - 1 (flip) or
  // log2(j) of t * E is clear.
  int which = 0;
  for (int k = 2 * E; k <= n_pad; k <<= 1) {
    const int half = k >> 1;
    const bool lo_flip = (base & half) == 0;
    if (half >= 32 * E) {
      if (!two_buffers) __syncthreads();
      shared_stage<E, true>(c, buf + (size_t)which * held, threads, t,
                            (k - 1) / E, lo_flip);
      which ^= two_buffers;
    } else {
      shuffle_stage<E, true>(c, ((k - 1) / E) & 31, lo_flip);
    }
    int j = k >> 2;
    for (; j >= 32 * E; j >>= 1) {
      if (!two_buffers) __syncthreads();
      shared_stage<E, false>(c, buf + (size_t)which * held, threads, t,
                             j / E, (base & j) == 0);
      which ^= two_buffers;
    }
    for (; j >= E; j >>= 1)
      shuffle_stage<E, false>(c, j / E, (lane & (j / E)) == 0);
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1)   // partner in this thread
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & jj)) exchange(c[e], c[e | jj]);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base + e;
    if (i < n) {
      const int src = key_index(c[e]);
      out_idx[row * n + i] = src;
      out_s[row * n + i] = srow[src];
    }
  }
}

int max_optin_bytes() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

// launch one instance; the shared-memory opt-in is set once per instance
// and size, only past the default 48 KB
template <int E>
int launch(const float* s, float* out_s, int64_t* out_idx, int rows, int n,
           int n_pad, cudaStream_t stream) {
  static size_t opted = kDefaultSmem;
  const int warps = (n + 32 * E - 1) / (32 * E);
  const int threads = (warps > 0 ? warps : 1) * 32;
  size_t smem = 0;
  int two = 0;
  if (threads > 32) {
    const size_t one = (size_t)threads * E * sizeof(uint64_t);
    two = 2 * one <= (size_t)max_optin_bytes();
    smem = two ? 2 * one : one;
  }
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        bitonic_sort_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  bitonic_sort_kernel<E><<<rows, threads, smem, stream>>>(s, out_s, out_idx,
                                                          n, n_pad, two);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int max_shared_bytes() { return max_optin_bytes(); }

// s (rows, n) f32; out_s (rows, n) f32; out_idx (rows, n) int64; n_pad is
// the power of two >= max(n, 32), at most 16,384.
int singular_sort(const float* s, float* out_s, int64_t* out_idx, int rows,
                  int n, int n_pad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_pad < 32 || (n_pad & (n_pad - 1)) || n_pad > kMaxPad)
    return (int)cudaErrorInvalidValue;
  // kRegs keys a thread, at least one warp, at most kMaxThreads
  int e = n_pad / 32 < kRegs ? n_pad / 32 : kRegs;
  if (n_pad / e > kMaxThreads) e = n_pad / kMaxThreads;
  switch (e) {
    case 1: return launch<1>(s, out_s, out_idx, rows, n, n_pad, st);
    case 2: return launch<2>(s, out_s, out_idx, rows, n, n_pad, st);
    case 4: return launch<4>(s, out_s, out_idx, rows, n, n_pad, st);
    case 8: return launch<8>(s, out_s, out_idx, rows, n, n_pad, st);
    default: return launch<16>(s, out_s, out_idx, rows, n, n_pad, st);
  }
}

}  // extern "C"
