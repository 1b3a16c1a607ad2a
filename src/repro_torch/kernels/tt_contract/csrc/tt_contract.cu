// Fused TT-chain contraction kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/tt_contract/kernel.py:
//   tt_contract_2  (_tt2_kernel)   y = (x . g0) . g1
//   tt_contract_3  (_tt3_kernel)   3-core chain, split 1 (expand) or 2 (contract)
//   tt_contract_2q / tt_contract_3q (_tt2q_kernel, _tt3q_kernel): the same with
//   the tail cores stored as int8, widened in registers, and the product of the
//   per-core scales applied once to the output.
// and the expert-batched chain of src/repro/kernels/tt_contract/ops.py
// (tt_contract_batched, a jax.vmap of the four over the expert axis): E
// chains that differ only in their lead-absorbed first core and share the
// tail cores and the scale, all in the same two launches.
// One template on the tail cores' storage type: float or bf16 (the wide
// kernels; serving stores cores in the weights' dtype) and int8.
//
// The TPU design keeps every core whole in VMEM and tiles only the token axis.
// At full model width the cores are megabytes (the wq first core alone is
// 1024 x 417 f32 = 1.7 MB), far past the 227 KB of shared memory a block has,
// and decode batches are a few rows, so a token-only grid would give one block.
// Here each chain runs as two launches around its narrowest rank:
//
//   phase A  contract the input side into per-chunk partial sums of the rank
//            vector (B x R floats per chunk).  The grid splits the contracted
//            input mode into chunks (and tokens, and rank columns), so the big
//            input core is read once, spread over many SMs.
//   phase B  sum the partials in a fixed order (deterministic), then expand
//            through the output cores.  The grid splits N_out across blocks as
//            well as tokens.
//
// Cores are streamed in tiles: output-side tiles go through shared memory
// (each element is reused by every token row of the block); input-side core
// elements that one thread alone consumes go straight to registers.  Nothing
// assumes a core fits on chip.  Accumulation is f32 throughout (FFMA on the
// CUDA cores, no TF32), matching preferred_element_type=f32 on the TPU.
//
// At decode batch sizes every phase is bound by the bytes of the cores it
// reads (a few FLOPs per byte); see PERF.md for times beside that bound.
//
// Expert axis: the token-tile grid axis (z in phase A, y in phase B) runs
// over E * ceil(B / 8) tiles, expert-major.  Each block offsets x, the first
// core, the partials and y by its expert's stride; the tail cores and the
// scale are shared.  A single chain is E = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // token rows per block
constexpr int kXTile = 128;     // x columns staged per step (phase A, split 1)
constexpr int kColTile = 32;    // rank columns per phase-A block (split 1)
constexpr int kSTile = 64;      // r2 columns per phase-A block (split 2)
constexpr int kRChunk = 64;     // r1 chunk staged per step (phase A, split 2)
constexpr int kOutTile = 128;   // output columns per phase-B block
constexpr int kTChunk = 256;    // rank-vector chunk staged per step (phase B)
constexpr int kGRows = 32;      // core rows staged per step (phase B)
constexpr int kSChunk = 32;     // r2 chunk (phase B, split 1)

static_assert(kThreads / kColTile == kRows, "phase A split 1 thread map");
static_assert(kRows * kSChunk == kThreads, "phase B split 1 thread map");
constexpr int kSRows = kThreads / kSTile;            // 4 row groups
constexpr int kSRowsPerThread = kRows / kSRows;      // 2
constexpr int kORows = kThreads / kOutTile;          // 2 row groups
constexpr int kORowsPerThread = kRows / kORows;      // 4

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Split a token-tile grid index into (expert, first token row of the tile).
__device__ __forceinline__ int expert_tile(int tile, int B, int* row0) {
  const int rt = (B + kRows - 1) / kRows;
  *row0 = (tile % rt) * kRows;
  return tile / rt;
}

// Phase A, split 1: part[c, b, r] = sum_{k in chunk c} x[b, k] * g0[k, r].
// grid (nchunk, ceil(r1 / 32), E * ceil(B / 8)); 8 warps share the k-range.
__global__ void __launch_bounds__(kThreads) reduce_in_kernel(
    const float* __restrict__ x, const float* __restrict__ g0,
    float* __restrict__ part, int B, int n1, int r1, int kchunk) {
  __shared__ float xs[kRows][kXTile];
  __shared__ float red[kRows][kRows][kColTile];
  const int lane = threadIdx.x % kColTile;
  const int warp = threadIdx.x / kColTile;
  const int col = blockIdx.y * kColTile + lane;
  int row0;
  const size_t e = expert_tile(blockIdx.z, B, &row0);
  x += e * B * n1;
  g0 += e * n1 * r1;
  part += e * gridDim.x * B * r1;
  const int k0 = blockIdx.x * kchunk;
  const int k1 = min(n1, k0 + kchunk);
  float acc[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
  for (int kt = k0; kt < k1; kt += kXTile) {
    const int kl = min(kXTile, k1 - kt);
    for (int i = threadIdx.x; i < kRows * kXTile; i += kThreads) {
      const int t = i / kXTile, kk = i % kXTile, row = row0 + t;
      xs[t][kk] = (row < B && kk < kl) ? x[(size_t)row * n1 + kt + kk] : 0.f;
    }
    __syncthreads();
    if (col < r1) {
      for (int kk = warp; kk < kl; kk += kRows) {
        const float g = g0[(size_t)(kt + kk) * r1 + col];
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = fmaf(xs[t][kk], g, acc[t]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) red[warp][t][lane] = acc[t];
  __syncthreads();
  const int row = row0 + warp;  // now warp w reduces token row w
  if (row < B && col < r1) {
    float s = 0.f;
    for (int w = 0; w < kRows; ++w) s += red[w][warp][lane];
    part[((size_t)blockIdx.x * B + row) * r1 + col] = s;
  }
}

// Phase A, split 2: x is (B, n1, n2); g0 (n1, r1); g1 (r1, n2, r2) as stored.
// part[c, b, s] = sum_{i2 in chunk c} sum_r (sum_a x[b, a, i2] g0[a, r]) g1[r, i2, s].
// Streams over i2 (n_mid) and r1 chunks, so the (B, n2 * r1) intermediate
// never exists: only a (8 x 64) slice of it lives in shared memory.
// grid (nchunk, ceil(r2 / 64), E * ceil(B / 8)).
template <typename T>
__global__ void __launch_bounds__(kThreads) contract2_kernel(
    const float* __restrict__ x, const float* __restrict__ g0,
    const T* __restrict__ g1, float* __restrict__ part, int B, int n1, int n2,
    int r1, int r2, int ichunk) {
  __shared__ float ts[kRows][kRChunk];
  __shared__ float gs[kRChunk][kSTile];
  const int s_lane = threadIdx.x % kSTile;
  const int rgrp = threadIdx.x / kSTile;
  const int s = blockIdx.y * kSTile + s_lane;
  int row0;
  const size_t e = expert_tile(blockIdx.z, B, &row0);
  const size_t n_in = (size_t)n1 * n2;
  x += e * B * n_in;
  g0 += e * n1 * r1;
  part += e * gridDim.x * B * r2;
  const int i_begin = blockIdx.x * ichunk;
  const int i_end = min(n2, i_begin + ichunk);
  float acc[kSRowsPerThread];
#pragma unroll
  for (int u = 0; u < kSRowsPerThread; ++u) acc[u] = 0.f;
  for (int i2 = i_begin; i2 < i_end; ++i2) {
    for (int r0 = 0; r0 < r1; r0 += kRChunk) {
      const int rl = min(kRChunk, r1 - r0);
      for (int i = threadIdx.x; i < kRows * kRChunk; i += kThreads) {
        const int t = i / kRChunk, j = i % kRChunk, row = row0 + t;
        float v = 0.f;
        if (row < B && j < rl) {
          const float* xr = x + (size_t)row * n_in + i2;
          const float* gc = g0 + r0 + j;
          for (int a = 0; a < n1; ++a)
            v = fmaf(xr[(size_t)a * n2], gc[(size_t)a * r1], v);
        }
        ts[t][j] = v;
      }
      for (int i = threadIdx.x; i < kRChunk * kSTile; i += kThreads) {
        const int j = i / kSTile, q = i % kSTile;
        const int sc = blockIdx.y * kSTile + q;
        gs[j][q] = (j < rl && sc < r2)
                       ? widen(g1[((size_t)(r0 + j) * n2 + i2) * r2 + sc])
                       : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < rl; ++j) {
        const float g = gs[j][s_lane];
#pragma unroll
        for (int u = 0; u < kSRowsPerThread; ++u)
          acc[u] = fmaf(ts[rgrp + u * kSRows][j], g, acc[u]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int u = 0; u < kSRowsPerThread; ++u) {
    const int row = row0 + rgrp + u * kSRows;
    if (row < B && s < r2) part[((size_t)blockIdx.x * B + row) * r2 + s] = acc[u];
  }
}

// Stage ts[t][j] = sum_c part[c, row0 + t, r0 + j] (fixed order over c).
__device__ __forceinline__ void load_rank_chunk(
    float (*ts)[kTChunk], const float* __restrict__ part, int B, int nchunk,
    int r, int row0, int r0, int rl) {
  for (int i = threadIdx.x; i < kRows * kTChunk; i += kThreads) {
    const int t = i / kTChunk, j = i % kTChunk, row = row0 + t;
    float v = 0.f;
    if (row < B && j < rl)
      for (int c = 0; c < nchunk; ++c) v += part[((size_t)c * B + row) * r + r0 + j];
    ts[t][j] = v;
  }
}

// Phase B, one output core: y[b, n] = scale * sum_r t[b, r] g[r, n],
// t = sum over the phase-A partials.  grid (ceil(n / 128), E * ceil(B / 8)).
template <typename T>
__global__ void __launch_bounds__(kThreads) expand1_kernel(
    const float* __restrict__ part, const T* __restrict__ g,
    const float* __restrict__ scale, float* __restrict__ y, int B, int nchunk,
    int r, int n) {
  __shared__ float ts[kRows][kTChunk];
  __shared__ float gs[kGRows][kOutTile];
  const int lane = threadIdx.x % kOutTile;
  const int rgrp = threadIdx.x / kOutTile;
  const int col = blockIdx.x * kOutTile + lane;
  int row0;
  const size_t e = expert_tile(blockIdx.y, B, &row0);
  part += e * nchunk * B * r;
  y += e * B * n;
  float acc[kORowsPerThread];
#pragma unroll
  for (int u = 0; u < kORowsPerThread; ++u) acc[u] = 0.f;
  for (int r0 = 0; r0 < r; r0 += kTChunk) {
    const int rl = min(kTChunk, r - r0);
    load_rank_chunk(ts, part, B, nchunk, r, row0, r0, rl);
    for (int gr = 0; gr < rl; gr += kGRows) {
      const int gl = min(kGRows, rl - gr);
      __syncthreads();
      for (int i = threadIdx.x; i < kGRows * kOutTile; i += kThreads) {
        const int j = i / kOutTile, q = i % kOutTile;
        const int cq = blockIdx.x * kOutTile + q;
        gs[j][q] = (j < gl && cq < n) ? widen(g[(size_t)(r0 + gr + j) * n + cq]) : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < gl; ++j) {
        const float gv = gs[j][lane];
#pragma unroll
        for (int u = 0; u < kORowsPerThread; ++u)
          acc[u] = fmaf(ts[rgrp + u * kORows][gr + j], gv, acc[u]);
      }
    }
    __syncthreads();
  }
  const float sc = scale ? *scale : 1.f;
#pragma unroll
  for (int u = 0; u < kORowsPerThread; ++u) {
    const int row = row0 + rgrp + u * kORows;
    if (row < B && col < n) y[(size_t)row * n + col] = acc[u] * sc;
  }
}

// Phase B, two output cores (split 1):
// y[b, i2 * n3 + j] = scale * sum_s (sum_r t[b, r] g1[r, i2, s]) g2[s, j].
// grid (n2 * ceil(n3 / 128), E * ceil(B / 8)): one output mode index and one
// 128-column tile of n3 per block.
template <typename T>
__global__ void __launch_bounds__(kThreads) expand2_kernel(
    const float* __restrict__ part, const T* __restrict__ g1,
    const T* __restrict__ g2, const float* __restrict__ scale,
    float* __restrict__ y, int B, int nchunk, int r1, int n2, int r2, int n3) {
  __shared__ float ts[kRows][kTChunk];
  __shared__ float t2s[kRows][kSChunk];
  __shared__ float gs[kSChunk][kOutTile];
  const int jtiles = (n3 + kOutTile - 1) / kOutTile;
  const int i2 = blockIdx.x / jtiles;
  const int j0 = (blockIdx.x % jtiles) * kOutTile;
  int row0;
  const size_t e = expert_tile(blockIdx.y, B, &row0);
  part += e * nchunk * B * r1;
  y += e * B * n2 * n3;
  const int lane = threadIdx.x % kOutTile;
  const int rgrp = threadIdx.x / kOutTile;
  const int tq = threadIdx.x % kSChunk;
  const int tt = threadIdx.x / kSChunk;
  const size_t g1_stride = (size_t)n2 * r2;
  float acc[kORowsPerThread];
#pragma unroll
  for (int u = 0; u < kORowsPerThread; ++u) acc[u] = 0.f;
  for (int s0 = 0; s0 < r2; s0 += kSChunk) {
    const int sl = min(kSChunk, r2 - s0);
    float t2 = 0.f;
    for (int r0 = 0; r0 < r1; r0 += kTChunk) {
      const int rl = min(kTChunk, r1 - r0);
      __syncthreads();
      load_rank_chunk(ts, part, B, nchunk, r1, row0, r0, rl);
      __syncthreads();
      if (tq < sl) {
        const T* gp = g1 + ((size_t)r0 * n2 + i2) * r2 + s0 + tq;
        for (int j = 0; j < rl; ++j) t2 = fmaf(ts[tt][j], widen(gp[j * g1_stride]), t2);
      }
    }
    t2s[tt][tq] = (tq < sl) ? t2 : 0.f;
    for (int i = threadIdx.x; i < kSChunk * kOutTile; i += kThreads) {
      const int j = i / kOutTile, q = i % kOutTile;
      gs[j][q] = (j < sl && j0 + q < n3) ? widen(g2[(size_t)(s0 + j) * n3 + j0 + q]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < sl; ++j) {
      const float gv = gs[j][lane];
#pragma unroll
      for (int u = 0; u < kORowsPerThread; ++u)
        acc[u] = fmaf(t2s[rgrp + u * kORows][j], gv, acc[u]);
    }
  }
  const float sc = scale ? *scale : 1.f;
  const size_t n_out = (size_t)n2 * n3;
#pragma unroll
  for (int u = 0; u < kORowsPerThread; ++u) {
    const int row = row0 + rgrp + u * kORows;
    if (row < B && j0 + lane < n3)
      y[(size_t)row * n_out + (size_t)i2 * n3 + j0 + lane] = acc[u] * sc;
  }
}

// token tiles of all E experts: the grid's expert-major tile axis
inline int row_tiles(int E, int B) { return E * ((B + kRows - 1) / kRows); }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch_chain2(const float* x, const float* g0, const T* g1,
                  const float* scale, float* part, float* y, int E, int B,
                  int n1, int r1, int n2, int kchunk, int nchunk,
                  cudaStream_t st) {
  const dim3 ga(nchunk, cdiv(r1, kColTile), row_tiles(E, B));
  reduce_in_kernel<<<ga, kThreads, 0, st>>>(x, g0, part, B, n1, r1, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gb(cdiv(n2, kOutTile), row_tiles(E, B));
  expand1_kernel<T><<<gb, kThreads, 0, st>>>(part, g1, scale, y, B, nchunk, r1, n2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain3_split1(const float* x, const float* g0, const T* g1,
                         const T* g2, const float* scale, float* part, float* y,
                         int E, int B, int n1, int r1, int n2, int r2, int n3,
                         int kchunk, int nchunk, cudaStream_t st) {
  const dim3 ga(nchunk, cdiv(r1, kColTile), row_tiles(E, B));
  reduce_in_kernel<<<ga, kThreads, 0, st>>>(x, g0, part, B, n1, r1, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gb(n2 * cdiv(n3, kOutTile), row_tiles(E, B));
  expand2_kernel<T><<<gb, kThreads, 0, st>>>(part, g1, g2, scale, y, B, nchunk,
                                             r1, n2, r2, n3);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain3_split2(const float* x, const float* g0, const T* g1,
                         const T* g2, const float* scale, float* part, float* y,
                         int E, int B, int n1, int n2, int r1, int r2, int n3,
                         int ichunk, int nchunk, cudaStream_t st) {
  const dim3 ga(nchunk, cdiv(r2, kSTile), row_tiles(E, B));
  contract2_kernel<T><<<ga, kThreads, 0, st>>>(x, g0, g1, part, B, n1, n2, r1,
                                               r2, ichunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 gb(cdiv(n3, kOutTile), row_tiles(E, B));
  expand1_kernel<T><<<gb, kThreads, 0, st>>>(part, g2, scale, y, B, nchunk, r2, n3);
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points return a cudaError_t value (0 = launched).  Pointers are
// device pointers; `stream` is a cudaStream_t; `scale` is a device pointer to
// one f32 or null (no scaling); `part` is f32 scratch of E * nchunk * B * R
// floats.  Suffix = storage type of the tail cores: f32, bf16 (wide) or i8
// (quantized).  Each runs E chains: x (E, B, N_in), g0 (E, n1, r1), y
// (E, B, N_out), the tail cores and the scale shared; one chain is E = 1.
#define TT_EXPORTS(SUFFIX, T)                                                  \
  int tt_contract_2b_##SUFFIX(const float* x, const float* g0, const T* g1,    \
                              const float* scale, float* part, float* y,       \
                              int E, int B, int n1, int r1, int n2,            \
                              int kchunk, int nchunk, void* stream) {          \
    return launch_chain2<T>(x, g0, g1, scale, part, y, E, B, n1, r1, n2,       \
                            kchunk, nchunk, (cudaStream_t)stream);             \
  }                                                                            \
  int tt_contract_3s1b_##SUFFIX(const float* x, const float* g0, const T* g1,  \
                                const T* g2, const float* scale, float* part,  \
                                float* y, int E, int B, int n1, int r1,        \
                                int n2, int r2, int n3, int kchunk,            \
                                int nchunk, void* stream) {                    \
    return launch_chain3_split1<T>(x, g0, g1, g2, scale, part, y, E, B, n1,    \
                                   r1, n2, r2, n3, kchunk, nchunk,             \
                                   (cudaStream_t)stream);                      \
  }                                                                            \
  int tt_contract_3s2b_##SUFFIX(const float* x, const float* g0, const T* g1,  \
                                const T* g2, const float* scale, float* part,  \
                                float* y, int E, int B, int n1, int n2,        \
                                int r1, int r2, int n3, int ichunk,            \
                                int nchunk, void* stream) {                    \
    return launch_chain3_split2<T>(x, g0, g1, g2, scale, part, y, E, B, n1,    \
                                   n2, r1, r2, n3, ichunk, nchunk,             \
                                   (cudaStream_t)stream);                      \
  }

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

TT_EXPORTS(f32, float)
TT_EXPORTS(bf16, __nv_bfloat16)
TT_EXPORTS(i8, int8_t)

}  // extern "C"
