// Flash attention (prefill) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _flash_kernel, reached through ops.mha_flash): causal,
// optionally windowed attention with an online softmax in float32.
//   * q is scaled by sm_scale (D^-1/2) before Q K^T;
//   * a score is kept where q_pos >= k_pos (causal) and q_pos - k_pos <
//     window (window > 0); masked scores are -1e30, finite, as the
//     reference's, so a row's first tile that is wholly masked gets weight 1
//     and is wiped by alpha = exp(-1e30 - m) = 0 once a live score arrives;
//   * a row with l = 0 divides by 1; the output is written in q's type.
//
// Layout: q, o (B, S, Hq, D) and k, v (B, S, Hkv, D), contiguous, as the
// model hands them over; Q head h reads KV head h / (Hq / Hkv), so GQA needs
// no repeated copy of the KV heads (the reference's jnp.repeat).
//
// Design: one block per (64 query rows, head, batch row), 256 threads in a
// 16 x 16 grid.  The scaled Q tile stays in shared memory in float32; the
// key range is walked in 64-row K/V tiles, widened to float32 on the load.
// Each tile: a 4 x 4 register tile of scores per thread (Q K^T), masked and
// written to shared memory; four threads per row take the row max and the
// exponentials (online softmax, m and l per row in shared memory); then the
// 4 x (D/16) output accumulators of each thread, in registers, are rescaled
// and take P V.  Tiles wholly outside the causal band or the window are not
// visited; the result is the reference's, whose extra tiles contribute 0.
// Shared memory rows are padded by one float so that column reads do not
// collide in a bank; at D = 256 the block uses 214,528 bytes (dynamic
// shared memory, opted in above 48 KB).
//
// Bound: at the hybrid path's shape (20 heads x 4,096 rows, D = 256, window
// 2,048) the work is 1.29e11 FLOPs against 92 MB of traffic, so it is bound
// by operations: 0.130 ms at the tensor cores' bf16 rate.  This kernel does
// its products with float32 FMAs from shared memory (no tensor cores): a
// simple, exact first version.  wgmma with TMA-fed bf16 tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Q (kBQ x D+1), K (kBK x D+1), V (kBK x D), P (kBQ x kBK+1), m, l, alpha
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int Hq, int Hkv, int causal, int window,
    float scale) {
  constexpr int QS = D + 1;
  constexpr int KS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * QS;
  float* sv = sk + kBK * KS;
  float* sp = sv + kBK * D;
  float* s_m = sp + kBQ * PS;
  float* s_l = s_m + kBQ;
  float* s_alpha = s_l + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const size_t q_row = (size_t)Hq * D;
  const size_t kv_row = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  T* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    sq[r * QS + c] = qr < S ? to_f(qb[(size_t)qr * q_row + c]) * scale : 0.f;
  }
  if (tid < kBQ) {
    s_m[tid] = kMasked;
    s_l[tid] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // keys [kv_begin, kv_end) can be live for some row of this block
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kr < S) {
        kx = to_f(kb[(size_t)kr * kv_row + c]);
        vx = to_f(vb[(size_t)kr * kv_row + c]);
      }
      sk[r * KS + c] = kx;
      sv[r * D + c] = vx;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sk[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + tx + 16 * j;
        float s = sc[i][j];
        if (kr >= S) {
          s = -INFINITY;  // past the sequence (S < 64): never weighted
        } else {
          bool live = true;
          if (causal) live = live && qr >= kr;
          if (window > 0) live = live && qr - kr < window;
          if (!live) s = kMasked;
        }
        sp[(ty * 4 + i) * PS + tx + 16 * j] = s;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int r = tid / 4, part = tid % 4;
      float* prow = sp + r * PS;
      const float m_prev = s_m[r];
      float mx = m_prev;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = expf(prow[c] - mx);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - mx);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = mx;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s_alpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vx = sv[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vx, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qr = q0 + r;
    if (qr >= S) continue;
    float l = s_l[r];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      ob[(size_t)qr * q_row + tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int causal, int window, float scale,
           void* stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Hq, Hkv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Hq, int Hkv, int D, int causal, int window,
             float scale, void* stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q, o (B, S, Hq, D); k, v (B, S, Hkv, D); contiguous, on the device, all of
// one type.  D in {32, 64, 128, 256}; Hq % Hkv == 0; window <= 0 means none.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int D, int causal,
                        int window, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, Hq, Hkv, D, causal, window, scale,
                         stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int Hq, int Hkv, int D, int causal,
                         int window, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, D, causal, window,
                                 scale, stream);
}

}  // extern "C"
