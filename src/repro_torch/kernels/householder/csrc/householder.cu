// Householder panel factorization (the paper's HBD-ACC datapath) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/householder/kernel.py:
//   panel_factor          (_panel_kernel, grid (1,))
//   panel_factor_batched  (_panel_kernel_batched, grid (B,))
// Each factors an (M, b) panel by unblocked Householder QR: V (M, b)
// unit-lower reflectors, tau (b,), R (b, b), with the reference's `safe`
// branch (a zero column gives tau = 0 and v = 0).
//
// The TPU kernel holds the whole panel in VMEM in one program.  A block here
// has at most 227 KB of shared memory: a b = 32 f32 panel fits up to about
// 1,750 rows, enough for the batched buckets of a small convnet but not for
// the full-width unfoldings of a transformer (a 2,883,584 x 32 panel is
// 369 MB).  So there are two forms, with the same arithmetic:
//
//   panel_smem    one block (32 warps) per panel, the panel in shared memory,
//                 the column loop inside the kernel;
//   panel_stream  the panel streamed from device memory by many blocks, two
//                 launches per column: a sweep applies reflection j to its
//                 rows and accumulates its rows' partial sums for column
//                 j + 1, and a one-block finalize sums the partials in a
//                 fixed order (deterministic) and forms tau, v1, the pivot
//                 and w for j + 1.  2b + 1 launches per panel.
//
// One warp works on one row at a time, lane c holding column c (b <= 32).
// Column j needs ||x|| and w = v^T A; with v = x / v1 (v_j = 1) both come
// from one pass, the sums S_c = sum_{r>j} x_r A[r, c]:
//   ||x||^2 = x_j^2 + S_j,   w_c = S_c / v1 + A[j, c]   (c > j),
// so each column costs one read and one write of the panel.  Columns left
// of j are not touched again (the reference updates them by a rounding
// residual that never reaches V, tau or R).  The streamed form is bound by
// bytes: b passes over the panel, each reading and writing it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxB = 32;
constexpr int kScal = 40;          // per member: w[32], tau, v1, pivot, safe
constexpr int kSmemThreads = 1024;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kUnroll = 4;         // rows in flight per warp (streamed form)

struct Step {
  float tau, v1, pivot, safe;
};

// HOUSE for column j from the sums S (lane c: sum_{r>j} x_r A[r, c]), the
// pivot entry x1 = A[j, j] and the lane's entry of row j.  Returns the lane's
// w_c (0 for c <= j).
__device__ __forceinline__ float house(float S, float x1, float arow, int lane,
                                       int j, int b, Step* st) {
  const float sumsq = __shfl_sync(kFull, S, j);
  const float norm = sqrtf(x1 * x1 + sumsq);
  const float sgn = x1 >= 0.f ? 1.f : -1.f;
  const float v1 = x1 + sgn * norm;
  const bool safe = fabsf(v1) > 0.f;
  st->tau = safe ? sgn * v1 / (norm == 0.f ? 1.f : norm) : 0.f;
  st->v1 = v1;
  st->pivot = -sgn * norm;
  st->safe = safe ? 1.f : 0.f;
  return (safe && lane > j && lane < b) ? S / v1 + arow : 0.f;
}

// Reflection j applied to row r >= j, held across the warp (lane c = column
// c).  Returns the lane's new entry in V format: columns > j updated, column
// j becomes v_r (v_j = safe), columns < j unchanged.  For r == j, *rval gets
// the lane's entry of R's row j.
__device__ __forceinline__ float reflect(float val, int r, int lane, int j,
                                         float w, const Step& st,
                                         float* rval) {
  const float x = __shfl_sync(kFull, val, j);
  const float vr = (r == j) ? st.safe : (st.safe != 0.f ? x / st.v1 : 0.f);
  const float nv = lane > j ? val - (st.tau * vr) * w : (lane == j ? vr : val);
  if (r == j) *rval = lane > j ? nv : (lane == j ? st.pivot : 0.f);
  return nv;
}

// ---------------------------------------------------------------------------
// Shared-memory form: one block per panel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSmemThreads) panel_smem_kernel(
    const float* __restrict__ src, long long lds, long long sbs,
    float* __restrict__ V, float* __restrict__ tau_out, float* __restrict__ R,
    int m, int b) {
  extern __shared__ float P[];                 // m * b, row-major
  __shared__ float red[kSmemThreads / 32][32];
  __shared__ float sw[32];
  __shared__ Step sst;
  const int member = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kWarps = kSmemThreads / 32;
  const float* A = src + (size_t)member * sbs;
  float* Rm = R + (size_t)member * b * b;
  for (int e = tid; e < m * b; e += kSmemThreads) {
    const int r = e / b, c = e % b;
    P[e] = A[(size_t)r * lds + c];
  }
  __syncthreads();
  for (int j = 0; j < b; ++j) {
    float acc = 0.f;
    for (int r = j + 1 + warp; r < m; r += kWarps) {
      const float val = lane < b ? P[r * b + lane] : 0.f;
      const float x = __shfl_sync(kFull, val, j);
      acc += x * val;
    }
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
      float S = 0.f;
      for (int k = 0; k < kWarps; ++k) S += red[k][lane];
      const bool has = j < m;
      const float x1 = has ? P[j * b + j] : 0.f;
      const float arow = (has && lane < b) ? P[j * b + lane] : 0.f;
      Step st;
      sw[lane] = house(S, x1, arow, lane, j, b, &st);
      if (lane == 0) {
        sst = st;
        tau_out[(size_t)member * b + j] = st.tau;
      }
    }
    __syncthreads();
    const Step st = sst;
    const float w = sw[lane];
    for (int r = warp; r < m; r += kWarps) {
      if (r < j) {                 // V is zero above the diagonal
        if (lane == j) P[r * b + j] = 0.f;
        continue;
      }
      const float val = lane < b ? P[r * b + lane] : 0.f;
      float rv = 0.f;
      const float nv = reflect(val, r, lane, j, w, st, &rv);
      if (lane < b) {
        P[r * b + lane] = nv;
        if (r == j) Rm[j * b + lane] = rv;
      }
    }
    __syncthreads();
  }
  float* Vm = V + (size_t)member * m * b;
  for (int e = tid; e < m * b; e += kSmemThreads) Vm[e] = P[e];
}

// ---------------------------------------------------------------------------
// Streamed form.  buf is V itself: it holds the working panel, and column j
// reaches its final V values in sweep j.
// ---------------------------------------------------------------------------

// Rows [blk * rpb, min(m, (blk + 1) * rpb)) of member blockIdx.y.  j == -1
// copies the rows from src into buf; j >= 0 applies reflection j (scalars
// from scal).  Then, when j + 1 < b, the partial sums for column j + 1 over
// these rows (r > j + 1) go to part[member][blk][lane].
__global__ void __launch_bounds__(kSweepThreads) panel_sweep_kernel(
    const float* __restrict__ src, long long lds, long long sbs,
    float* __restrict__ buf, float* __restrict__ R,
    const float* __restrict__ scal, float* __restrict__ part, int m, int b,
    int j, int rpb, int nblk) {
  __shared__ float red[kSweepWarps][32];
  const int member = blockIdx.y;
  const int blk = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* Bm = buf + (size_t)member * m * b;
  const float* A = src + (size_t)member * sbs;
  const int r0 = blk * rpb;
  const int r1 = min(m, r0 + rpb);
  Step st = {0.f, 1.f, 0.f, 0.f};
  float w = 0.f;
  if (j >= 0) {
    const float* sc = scal + (size_t)member * kScal;
    w = sc[lane];
    st.tau = sc[32];
    st.v1 = sc[33];
    st.pivot = sc[34];
    st.safe = sc[35];
  }
  const int jn = j + 1;
  float acc = 0.f;
  for (int rb = r0 + warp; rb < r1; rb += kSweepWarps * kUnroll) {
    float vals[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + kSweepWarps * u;
      vals[u] = 0.f;
      if (r < r1 && lane < b)
        vals[u] = j < 0 ? A[(size_t)r * lds + lane] : Bm[(size_t)r * b + lane];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = rb + kSweepWarps * u;
      if (r >= r1) break;
      float val = vals[u];
      if (j < 0) {
        if (lane < b) Bm[(size_t)r * b + lane] = val;
      } else if (r < j) {          // V is zero above the diagonal
        if (lane == j) Bm[(size_t)r * b + j] = 0.f;
        continue;
      } else {
        float rv = 0.f;
        val = reflect(val, r, lane, j, w, st, &rv);
        if (lane < b) {
          Bm[(size_t)r * b + lane] = val;
          if (r == j) R[((size_t)member * b + j) * b + lane] = rv;
        }
      }
      if (jn < b && r > jn) {
        const float x = __shfl_sync(kFull, val, jn);
        acc += x * val;
      }
    }
  }
  if (jn >= b) return;
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
    for (int k = 0; k < kSweepWarps; ++k) s += red[k][lane];
    part[((size_t)member * nblk + blk) * 32 + lane] = s;
  }
}

// Column j of member blockIdx.x: sums the sweep's partials in block order
// (warp k takes blocks k, k + 8, ...; then warp 0 adds the 8 in order) and
// forms the reflector's scalars and w.
__global__ void __launch_bounds__(kSweepThreads) panel_finalize_kernel(
    const float* __restrict__ buf, const float* __restrict__ part,
    float* __restrict__ scal, float* __restrict__ tau_out, int m, int b, int j,
    int nblk) {
  __shared__ float red[kSweepWarps][32];
  const int member = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float* p = part + (size_t)member * nblk * 32 + lane;
  float s = 0.f;
  for (int k = warp; k < nblk; k += kSweepWarps) s += p[(size_t)k * 32];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float S = 0.f;
  for (int k = 0; k < kSweepWarps; ++k) S += red[k][lane];
  const float* Bm = buf + (size_t)member * m * b;
  const bool has = j < m;
  const float x1 = has ? Bm[(size_t)j * b + j] : 0.f;
  const float arow = (has && lane < b) ? Bm[(size_t)j * b + lane] : 0.f;
  Step st;
  const float wv = house(S, x1, arow, lane, j, b, &st);
  float* sc = scal + (size_t)member * kScal;
  sc[lane] = wv;
  if (lane == 0) {
    sc[32] = st.tau;
    sc[33] = st.v1;
    sc[34] = st.pivot;
    sc[35] = st.safe;
    tau_out[(size_t)member * b + j] = st.tau;
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

// Static shared memory of the one-block form, for the wrapper's size check.
int panel_smem_static_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, panel_smem_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}

// src: B panels of (m, b) floats, rows at stride lds, members at stride sbs.
// V (B, m, b), tau (B, b), R (B, b, b) zero-filled by the caller.
int panel_factor_smem(const float* src, long long lds, long long sbs, float* V,
                      float* tau, float* R, int B, int m, int b,
                      void* stream) {
  if (b > kMaxB) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * b * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      panel_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  panel_smem_kernel<<<B, kSmemThreads, smem, (cudaStream_t)stream>>>(
      src, lds, sbs, V, tau, R, m, b);
  return (int)cudaGetLastError();
}

// As panel_factor_smem, streamed: scal scratch of B * 40 floats, part
// scratch of B * nblk * 32 floats; each member's rows split into nblk blocks
// of rpb rows.
int panel_factor_stream(const float* src, long long lds, long long sbs,
                        float* V, float* tau, float* R, float* scal,
                        float* part, int B, int m, int b, int rpb, int nblk,
                        void* stream) {
  if (b > kMaxB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g(nblk, B);
  panel_sweep_kernel<<<g, kSweepThreads, 0, st>>>(src, lds, sbs, V, R, scal,
                                                  part, m, b, -1, rpb, nblk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int j = 0; j < b; ++j) {
    panel_finalize_kernel<<<B, kSweepThreads, 0, st>>>(V, part, scal, tau, m,
                                                       b, j, nblk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    panel_sweep_kernel<<<g, kSweepThreads, 0, st>>>(src, lds, sbs, V, R, scal,
                                                    part, m, b, j, rpb, nblk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
