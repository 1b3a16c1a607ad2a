// Householder panel factorization (the paper's HBD-ACC datapath) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/householder/kernel.py:
//   panel_factor          (_panel_kernel, grid (1,))
//   panel_factor_batched  (_panel_kernel_batched, grid (B,))
// Each factors an (M, b) panel as unblocked Householder QR does: V (M, b)
// unit-lower reflectors, tau (b,), R (b, b) with R_jj = -sign(x1)||x||, and
// the reference's `safe` branch (a zero column gives tau = 0 and v = 0).
//
// The TPU kernel holds the whole panel in VMEM in one program.  A block here
// has at most 227 KB of shared memory: a b = 32 f32 panel fits up to about
// 1,750 rows, enough for the batched buckets of a small convnet but not for
// the full-width unfoldings of a transformer (a 19,447,808 x 32 panel is
// 2.49 GB).  So there are three routes:
//
//   panel_smem    one block (32 warps) per panel, the panel in shared memory,
//                 the column loop inside the kernel;
//   panel_tsqr    taller panels: TSQR with Householder reconstruction
//                 (Ballard, Demmel, Grigori, Jacquelin, Nguyen, Solomonik,
//                 "Reconstructing Householder vectors from tall-skinny QR",
//                 IPDPS 2014), three launches whatever the height;
//   panel_stream  the sweep: two launches per column (a sweep over every
//                 row applies reflection j and sums column j + 1's partials,
//                 a one-block finalize forms tau, v1, the pivot and w),
//                 2b + 1 launches and b passes over the panel.  Kept for
//                 panels with an exactly zero column before a nonzero one,
//                 whose reference Q column is e_j-like rather than A's, which
//                 the reconstruction cannot give; no main path makes one.
//
// The column arithmetic (smem and sweep; the TSQR steps use the same HOUSE):
// one warp works on one row at a time, lane c holding column c (b <= 32).
// Column j needs ||x|| and w = v^T A; with v = x / v1 (v_j = 1) both come
// from one pass, the sums S_c = sum_{r>j} x_r A[r, c]:
//   ||x||^2 = x_j^2 + S_j,   w_c = S_c / v1 + A[j, c]   (c > j).
// Columns left of j are not touched again (the reference updates them by a
// rounding residual that never reaches V, tau or R).
//
// The TSQR route.  What bounds a tall panel: one read of A and one write of
// V (19,447,808 x 32: 4.98 GB, 1.49 ms at 3.35 TB/s) against ~3 x 2 m b^2
// FLOPs of FP32 FMA (~2 ms at 67 TFLOP/s), so FMA issue and bytes are close;
// the sweep moved the panel 2b times instead.  In practice each chain step
// is bound by its 32 dependent column steps (a reduction, a barrier, HOUSE,
// an update), which two blocks an SM overlap.  Every step is a structured
// Householder QR of [R; X] (R a 32 x 32 running triangle, X a tile of 512
// rows, two a thread in registers): per column each thread sums
// x . X[:, c] over its rows, the warp reduce-scatters the 32 sums (lane c
// ends with column c), and after one barrier every warp adds the 8 warps'
// sums in order and forms HOUSE in float32 for its rows (a switch on j keeps
// the rows in registers).  The reflectors are [I; Y]; Y goes to V's rows.
// After the column loop the same HOUSE is redone in double from the kept
// sums for R's rows, Z and tau, and T comes from them (forward LARFT): in a
// chain R grows tile by tile, and float32 copies of R, T or the walked C put
// an error of eps ||R|| into Q R at every step (the residual grew with the
// chain's length), which double removes.  The next tile's copy flies while
// a step is factored.
//   leaf   (grid chains x B): each chain takes ~ntiles/264 tiles from the
//          bottom one up, R from zero; T per tile and the chain's R go to
//          scratch, with a mask of the columns holding a nonzero;
//   tree   (grid B, 512 threads: steps of 1,024 rows, half as many as
//          leaf-sized steps would be): one more chain over the stacked
//          leaf R's; its Q walked
//          down from the top tile (C = I; rows -Y T C, C <- C - T C) gives
//          each leaf chain's 32 x 32 block C_c.  Then the top block, in
//          double: Q1 = -Y_0[0:32] T_0 C_0 (top tile of chain 0), the LU
//          Q1 - S = L U with S_jj = -sign(q) of the running diagonal q, so
//          U_jj = q + sign(q) and |U_jj| >= 1 (no pivoting needed).  With
//          Q~ = Q S the Householder Q of A: Q~ - E = L U S = -V T~ V1^T, so
//          V = L, T~ = -U S V1^-T, tau_j = -U_jj S_jj = 1 + |q| in [1, 2]
//          (Householder's own range) and R = S R_tsqr.  Only the k leading
//          columns with a nonzero are factored (k from the leaf masks):
//          trailing zero columns get V = 0, tau = 0 and zero R, as the
//          safe branch does;
//   apply  (grid chains x B): each chain walks its tiles from the top with
//          C' = C_c U^-1: W = T C', V's rows = -Y W (below row 32; the tree
//          wrote L there), C' <- C' - W.  Then tau_j = 2 / ||v_j||^2 from V
//          itself (the last chain to finish adds the chains' column sums in
//          order; an integer counter picks it): equal to -U_jj S_jj in exact
//          arithmetic, and consistent with V to rounding, so Q = I - V T V^T
//          is orthogonal to ~1 float32 ulp.
// Sums run in a fixed order and no float atomics are used, so repeat calls
// give the same bits.  The route reads the panel twice and writes V twice.

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
// Sweep route (panel_factor_stream).  buf is V itself: it holds the working
// panel, and column j reaches its final V values in sweep j.
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

// ---------------------------------------------------------------------------
// TSQR route.  Three launches a panel: leaf chains, tree + top block, apply.
// The running R, T, the walked C and the top block are kept in double: in a
// chain the R rows grow with every tile, and float32 copies of T or C would
// put an error of eps ||R|| into Q R at each step (measured: the residual
// grew with the chain length).  Y and the tile arithmetic stay in float32.
// ---------------------------------------------------------------------------

constexpr int kLeafThreads = 256;                // leaf and apply blocks
constexpr int kTreeThreads = 2 * kLeafThreads;   // the tree's block
constexpr int kRows = 2;                         // rows a thread holds
constexpr int kTile = kLeafThreads * kRows;      // rows of a leaf step
constexpr int kTreeTile = kTreeThreads * kRows;  // rows of a tree step
constexpr int kLd = 33;                          // a padded 32-entry row
constexpr int kMat = 32 * 32;

// the shared memory of a chain's block of NT threads
template <int NT>
struct __align__(16) TsqrSmem {
  float Wf[kMat];               // T C in float32 (read as float4)
  float tile[NT * kRows * kLd]; // a step's rows
  double R[32 * kLd];           // the running R; U^-1 in the apply pass
  double T[32 * kLd];           // a step's T; Z[j][c] = y_c . y_j in a chain
  double C[32 * kLd];           // the walked C; Q1, then L\U, in the top block
  double W[kMat];               // T C
  double tau[32];
  float S[32 * kLd];            // S[j][c]: column j's sums x . X[:, c]
  float red[2][NT / 32][32];    // the warps' column sums, by column parity
  int kcols;
  unsigned mask[NT / 32];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy one float to shared memory, or zero it when `bytes` is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + n) of a panel (row stride ld, ncols <= 32 columns) into
// tile, zero-filled to NT * kRows x 32; lane = column, every copy in flight
// at once (the caller waits, then a barrier)
template <int NT>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long long ld, int ncols,
                                          long long r0, int n, int warp,
                                          int lane) {
#pragma unroll 8
  for (int r = warp; r < NT * kRows; r += NT / 32) {
    const bool in = r < n && lane < ncols;
    cp_async4(tile + r * kLd + lane, in ? src + (r0 + r) * ld + lane : src,
              in ? 4 : 0);
  }
}

// a 32 x 32 double matrix into shared memory (row stride kLd), copies in
// flight as load_tile's
template <int NT>
__device__ __forceinline__ void load_mat(double* dst, const double* src,
                                         int warp, int lane) {
#pragma unroll
  for (int r = warp; r < 32; r += NT / 32)
    cp_async8(dst + r * kLd + lane, src + r * 32 + lane);
}

template <int NT>
__device__ __forceinline__ void store_mat(double* dst, const double* src,
                                          int warp, int lane) {
  for (int r = warp; r < 32; r += NT / 32)
    dst[r * 32 + lane] = src[r * kLd + lane];
}

// W = A B (32 x 32, double, row stride kLd for A and B), and Wf = W in
// float32; l summed in order; kOut consecutive outputs of one row a thread
template <int NT>
__device__ __forceinline__ void mm32(const double* A, const double* B,
                                     double* W, float* Wf, int ldw,
                                     int tid) {
  constexpr int kOut = kMat / NT, kGroups = 32 / kOut;
  const int i = tid / kGroups, c0 = (tid % kGroups) * kOut;
  double acc[kOut];
#pragma unroll
  for (int q = 0; q < kOut; ++q) acc[q] = 0.0;
#pragma unroll 8
  for (int l = 0; l < 32; ++l) {
    const double av = A[i * kLd + l];
#pragma unroll
    for (int q = 0; q < kOut; ++q)
      acc[q] = fma(av, B[l * kLd + c0 + q], acc[q]);
  }
#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    W[i * ldw + c0 + q] = acc[q];
    if (Wf) Wf[i * 32 + c0 + q] = (float)acc[q];
  }
}

// C <- C - W, the entries mm32 gave this thread
template <int NT>
__device__ __forceinline__ void sub_w(double* C, const double* W, int tid) {
  constexpr int kOut = kMat / NT, kGroups = 32 / kOut;
  const int i = tid / kGroups, c0 = (tid % kGroups) * kOut;
#pragma unroll
  for (int q = 0; q < kOut; ++q) C[i * kLd + c0 + q] -= W[i * 32 + c0 + q];
}

// each of the thread's tile rows y becomes -(y W)
template <int NT>
__device__ __forceinline__ void rows_times_w(float* tile, const float* W,
                                             int tid) {
#pragma unroll 1
  for (int i = 0; i < kRows; ++i) {
    float* row = tile + (tid + i * NT) * kLd;
    float y[32], o[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      y[l] = row[l];
      o[l] = 0.f;
    }
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const float4* wl = reinterpret_cast<const float4*>(W + l * 32);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = wl[q];
        o[4 * q] = fmaf(y[l], v.x, o[4 * q]);
        o[4 * q + 1] = fmaf(y[l], v.y, o[4 * q + 1]);
        o[4 * q + 2] = fmaf(y[l], v.z, o[4 * q + 2]);
        o[4 * q + 3] = fmaf(y[l], v.w, o[4 * q + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) row[c] = -o[c];
  }
}

// The warp's sums of p[c] (16 columns) scattered over its lanes: lane l
// ends with column l & 15 summed over all 32 lanes, in a fixed order.
__device__ __forceinline__ float reduce_scatter16(const float (&p)[16],
                                                  int lane) {
  float q8[8], q4[4], q2[2];
  bool hi = lane & 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float send = hi ? p[c] : p[c + 8];
    q8[c] = (hi ? p[c + 8] : p[c]) + __shfl_xor_sync(kFull, send, 8);
  }
  hi = lane & 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float send = hi ? q8[c] : q8[c + 4];
    q4[c] = (hi ? q8[c + 4] : q8[c]) + __shfl_xor_sync(kFull, send, 4);
  }
  hi = lane & 2;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float send = hi ? q4[c] : q4[c + 2];
    q2[c] = (hi ? q4[c + 2] : q4[c]) + __shfl_xor_sync(kFull, send, 2);
  }
  hi = lane & 1;
  const float q1 = (hi ? q2[1] : q2[0]) +
                   __shfl_xor_sync(kFull, hi ? q2[0] : q2[1], 1);
  return q1 + __shfl_xor_sync(kFull, q1, 16);
}

// 1 / x and sqrt(x) in double from float32 seeds and Newton steps (a
// few DFMAs, against the library routines' longer latency on the column
// loop's critical path); x > 0 and within float32's range
__device__ __forceinline__ bool in_f32_range(double x) {
  const double ax = fabs(x);
  return ax > 1e-36 && ax < 1e36;
}

__device__ __forceinline__ double rcp64(double x) {
  if (!in_f32_range(x)) return 1.0 / x;
  double r = (double)__frcp_rn((float)x);
#pragma unroll
  for (int i = 0; i < 2; ++i) r = fma(r, fma(-x, r, 1.0), r);
  return r;
}

__device__ __forceinline__ double sqrt64(double x) {
  if (x <= 0.0) return 0.0;
  if (!in_f32_range(x)) return sqrt(x);
  double y = (double)rsqrtf((float)x);     // 1 / sqrt(x)
#pragma unroll
  for (int i = 0; i < 2; ++i) y = y * fma(-0.5 * x * y, y, 1.5);
  const double s = x * y;
  return fma(0.5 * y, fma(-s, s, x), s);   // one more step on sqrt(x)
}

// HOUSE for column j of [R; X] in float32, by every warp (lane = column),
// for the body rows: S the sums x . X[:, c] over them, x1 = R[j][j] the
// pivot, rj = R[j][lane].  Returns the lane's w_c (columns > j) and sets
// tau and 1 / v1 (1 for a zero column).
__device__ __forceinline__ float house_f(float S, float x1, float rj, int j,
                                         int lane, float* tau, float* inv) {
  const float sumsq = __shfl_sync(kFull, S, j);
  const float norm = sqrtf(fmaf(x1, x1, sumsq));
  const float sgn = x1 >= 0.f ? 1.f : -1.f;
  const float v1 = x1 + sgn * norm;
  const bool safe = fabsf(v1) > 0.f;
  const float div = safe ? v1 : 1.f;
  *inv = 1.f / div;
  *tau = safe ? sgn * v1 / (norm == 0.f ? 1.f : norm) : 0.f;
  return (safe && lane > j) ? S / div + rj : 0.f;
}

// The same in double for R's row j, Z's row j (sm.T) and tau_j, from the
// column's sums kept in sm.S and R's row j, which no column but j changes;
// run for every column after the column loop, off its critical path, by
// warp j % (NT / 32) (the warp that kept the sums).
template <int NT>
__device__ __forceinline__ void house_r(TsqrSmem<NT>& sm, int j, int lane) {
  const double S = sm.S[j * kLd + lane];
  const double x1 = sm.R[j * kLd + j];
  const double rj = sm.R[j * kLd + lane];
  const double sumsq = __shfl_sync(kFull, S, j);
  const double norm = sqrt64(fma(x1, x1, sumsq));
  const double sgn = x1 >= 0.0 ? 1.0 : -1.0;
  const double v1 = x1 + sgn * norm;
  const bool safe = fabs(v1) > 0.0;
  const double inv = safe ? rcp64(v1) : 1.0;
  const double q = S * inv;                // S / v1
  const double wv = (safe && lane > j) ? q + rj : 0.0;
  __syncwarp();
  sm.T[j * kLd + lane] = (safe && lane < j) ? q : 0.0;
  if (lane > j) sm.R[j * kLd + lane] = fma(-(safe ? sgn * v1 * rcp64(norm)
                                                  : 0.0), wv, rj);
  if (lane == j) sm.R[j * kLd + j] = -sgn * norm;
  if (lane == 0) sm.tau[j] = safe ? sgn * v1 * rcp64(norm) : 0.0;
}

// the update of column J's reflection on the thread's rows: column J
// becomes v, columns past J lose t w (w_c from lane c); xn gets column J + 1
template <int J>
__device__ __forceinline__ void apply_column(float (&a)[kRows][32],
                                             const float (&v)[kRows],
                                             const float (&t)[kRows],
                                             float w, float (&xn)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) a[i][J] = v[i];
#pragma unroll
  for (int c = J + 1; c < 32; ++c) {
    const float wc = __shfl_sync(kFull, w, c);
#pragma unroll
    for (int i = 0; i < kRows; ++i) a[i][c] = fmaf(-t[i], wc, a[i][c]);
  }
  if (J + 1 < 32) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) xn[i] = a[i][(J + 1) & 31];
  }
}

// One structured Householder step on [R; X]: R (sm.R, 32 x 32 upper) over
// the block's tile X, the thread's rows in a.  Afterwards a holds Y (the
// reflectors are [I; Y]) and sm.S the columns' sums; house_r then makes
// sm.R the new R, and sm.tau and Z (sm.T) define T.  One barrier a column:
// every warp forms HOUSE from the warps' sums itself, in float32.
template <int NT>
__device__ __forceinline__ void factor_step(float (&a)[kRows][32],
                                            TsqrSmem<NT>& sm, int warp,
                                            int lane) {
  float x[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) x[i] = a[i][0];
#pragma unroll 1
  for (int j = 0; j < 32; ++j) {
    float s_lo, s_hi;
    {
      float p[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc = fmaf(x[i], a[i][c], acc);
        p[c] = acc;
      }
      s_lo = reduce_scatter16(p, lane);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc = fmaf(x[i], a[i][16 + c], acc);
        p[c] = acc;
      }
      s_hi = reduce_scatter16(p, lane);
    }
    float (&red)[NT / 32][32] = sm.red[j & 1];
    red[warp][lane] = lane < 16 ? s_lo : s_hi;
    __syncthreads();
    float sf = 0.f;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) sf += red[k][lane];
    if (warp == j % (NT / 32)) sm.S[j * kLd + lane] = sf;  // its house_r
    float tauf, invf;
    const float w = house_f(sf, (float)sm.R[j * kLd + j],
                            (float)sm.R[j * kLd + lane], j, lane, &tauf,
                            &invf);
    float v[kRows], t[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      v[i] = x[i] * invf;
      t[i] = tauf * v[i];
    }
    switch (j) {
#define TSQR_COL(J) \
  case J: apply_column<J>(a, v, t, w, x); break;
      TSQR_COL(0) TSQR_COL(1) TSQR_COL(2) TSQR_COL(3) TSQR_COL(4)
      TSQR_COL(5) TSQR_COL(6) TSQR_COL(7) TSQR_COL(8) TSQR_COL(9)
      TSQR_COL(10) TSQR_COL(11) TSQR_COL(12) TSQR_COL(13) TSQR_COL(14)
      TSQR_COL(15) TSQR_COL(16) TSQR_COL(17) TSQR_COL(18) TSQR_COL(19)
      TSQR_COL(20) TSQR_COL(21) TSQR_COL(22) TSQR_COL(23) TSQR_COL(24)
      TSQR_COL(25) TSQR_COL(26) TSQR_COL(27) TSQR_COL(28) TSQR_COL(29)
      TSQR_COL(30) TSQR_COL(31)
#undef TSQR_COL
      default: break;
    }
  }
}

// T of the last step (forward LARFT from sm.tau and Z = sm.T) to Tout;
// warp 0, lane i computes and stores row i (four partial sums for a
// shorter chain)
template <int NT>
__device__ __forceinline__ void build_t_rows(const TsqrSmem<NT>& sm, int lane,
                                             double* Tout) {
  double tr[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < j; ++c)
      acc[c & 3] = fma(tr[c], sm.T[j * kLd + c], acc[c & 3]);
    const double tj = sm.tau[j];
    const double sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    tr[j] = lane < j ? -tj * sum : (lane == j ? tj : 0.0);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) Tout[lane * 32 + j] = tr[j];
}

template <int NT>
__device__ __forceinline__ void read_rows(const float* tile,
                                          float (&a)[kRows][32], int tid) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 32; ++c)
      a[i][c] = tile[(tid + i * NT) * kLd + c];
}

// the thread's rows of a tile (rows r0 + tid + i * NT below n) to dst (row
// stride ldd, ncols columns) straight from registers: 16-byte stores for
// full 32-column rows, whose row starts are 16-byte aligned
template <int NT>
__device__ __forceinline__ void store_rows(const float (&a)[kRows][32],
                                           float* dst, long long ldd,
                                           int ncols, long long r0, int n,
                                           long long from, int tid) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = tid + i * NT;
    if (r >= n || r0 + r < from) continue;
    float* row = dst + (r0 + r) * ldd;
    if (ncols == 32 && (ldd & 3) == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        reinterpret_cast<float4*>(row)[q] = make_float4(
            a[i][4 * q], a[i][4 * q + 1], a[i][4 * q + 2], a[i][4 * q + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < ncols) row[c] = a[i][c];
    }
  }
}

// The chain over tiles [g0, g1) of a panel (row stride ld, ncols columns,
// m rows), bottom tile first, starting from sm.R = 0: each step's Y goes to
// dst (row stride ldd), its T to Tout + g * kMat.  The next tile is copied
// in while this one is factored (its rows are in registers by then).
// Returns the nonzero columns seen, as a bit mask (this thread's rows).
template <int NT>
__device__ __forceinline__ unsigned chain(TsqrSmem<NT>& sm, const float* src,
                                          long long ld, float* dst,
                                          long long ldd, int ncols,
                                          long long m, int g0, int g1,
                                          double* Tout, int tid) {
  constexpr int kStep = NT * kRows;
  const int lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < 32 * kLd; e += NT) sm.R[e] = 0.0;
  auto rows = [&](int g) {
    return (int)min((long long)kStep, m - (long long)g * kStep);
  };
  if (g1 > g0)
    load_tile<NT>(sm.tile, src, ld, ncols, (long long)(g1 - 1) * kStep,
                  rows(g1 - 1), warp, lane);
  unsigned nz = 0;
  for (int g = g1 - 1; g >= g0; --g) {
    cp_async_wait_all();
    __syncthreads();
    float a[kRows][32];
    read_rows<NT>(sm.tile, a, tid);
    __syncthreads();             // the tile buffer is free: fetch the next
    if (g > g0)
      load_tile<NT>(sm.tile, src, ld, ncols, (long long)(g - 1) * kStep,
                    rows(g - 1), warp, lane);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 32; ++c) nz |= a[i][c] != 0.f ? 1u << c : 0u;
    factor_step<NT>(a, sm, warp, lane);
    for (int j = warp; j < 32; j += NT / 32) house_r<NT>(sm, j, lane);
    store_rows<NT>(a, dst, ldd, ncols, (long long)g * kStep, rows(g), 0,
                   tid);
    __syncthreads();
    if (warp == 0) build_t_rows<NT>(sm, lane, Tout + (size_t)g * kMat);
  }
  __syncthreads();               // the last T stored before anyone reads it
  return nz;
}

// The TSQR route's scratch: T per leaf tile, T per tree tile, C_c per leaf
// chain, U^-1, the squares of V's columns per chain and of its top rows
// (doubles); the leaf R's, then the tree's Y (floats); the masks and a
// counter per member (ints).
struct TsqrScratch {
  double *Tt, *Ttree, *Cb, *Uinv, *nrm, *nrm_top;
  float* Rb;
  unsigned* masks;
  int* count;
};

int tsqr_trees(int nblk) { return (nblk * 32 + kTreeTile - 1) / kTreeTile; }

// doubles, floats and ints of the scratch
void tsqr_counts(int B, int ntiles, int nblk, size_t* nd, size_t* nf,
                 size_t* ni) {
  *nd = (size_t)B * kMat * (ntiles + tsqr_trees(nblk) + nblk + 1) +
        (size_t)B * 32 * (nblk + 1);
  *nf = (size_t)B * nblk * kMat;
  *ni = (size_t)B * (nblk + 1);
}

// carve the scratch at base; returns its size in bytes
size_t tsqr_scratch(TsqrScratch* sc, unsigned char* base, int B, int ntiles,
                    int nblk) {
  size_t nd, nf, ni;
  tsqr_counts(B, ntiles, nblk, &nd, &nf, &ni);
  if (sc) {
    double* d = reinterpret_cast<double*>(base);
    sc->Tt = d;
    sc->Ttree = sc->Tt + (size_t)B * ntiles * kMat;
    sc->Cb = sc->Ttree + (size_t)B * tsqr_trees(nblk) * kMat;
    sc->Uinv = sc->Cb + (size_t)B * nblk * kMat;
    sc->nrm = sc->Uinv + (size_t)B * kMat;
    sc->nrm_top = sc->nrm + (size_t)B * nblk * 32;
    sc->Rb = reinterpret_cast<float*>(d + nd);
    sc->masks = reinterpret_cast<unsigned*>(sc->Rb + nf);
    sc->count = reinterpret_cast<int*>(sc->masks + (size_t)B * nblk);
  }
  return nd * sizeof(double) + nf * sizeof(float) + ni * sizeof(int);
}

// Pass 1: member blockIdx.y, tiles [blk * tpb, (blk + 1) * tpb) of its
// panel: Y into V, T per tile into Tt, the chain's R into Rb, the columns
// holding a nonzero into masks.
__global__ void __launch_bounds__(kLeafThreads, 2) panel_tsqr_leaf_kernel(
    const float* __restrict__ src, long long lds, long long sbs,
    float* __restrict__ V, TsqrScratch sc, int m, int b, int tpb, int ntiles,
    int nblk) {
  constexpr int NT = kLeafThreads;
  extern __shared__ __align__(16) unsigned char raw[];
  TsqrSmem<NT>& sm = *reinterpret_cast<TsqrSmem<NT>*>(raw);
  const int member = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = blk * tpb, g1 = min(ntiles, g0 + tpb);
  unsigned nz = chain<NT>(sm, src + (size_t)member * sbs, lds,
                          V + (size_t)member * m * b, b, b, m, g0, g1,
                          sc.Tt + (size_t)member * ntiles * kMat, tid);
  float* Rm = sc.Rb + ((size_t)member * nblk + blk) * kMat;
  for (int e = tid; e < kMat; e += NT)
    Rm[e] = (float)sm.R[(e / 32) * kLd + e % 32];
  nz = __reduce_or_sync(kFull, nz);
  if (lane == 0) sm.mask[warp] = nz;
  __syncthreads();
  if (tid == 0) {
    unsigned all = 0;
    for (int k = 0; k < NT / 32; ++k) all |= sm.mask[k];
    sc.masks[(size_t)member * nblk + blk] = all;
  }
}

// Tree and top block, one block per member (kTreeThreads: steps of
// kTreeTile rows, half as many as leaf-sized ones): the chain over the
// stacked leaf R's (Y in place in Rb), its Q walked from the top tile into
// Cb (the 32 x 32 block C_c of each leaf chain), then Q's top 32 rows
// Q1 = -Y_0[0:32] T_0 C_0, the LU Q1 - S = L U (S_jj = -sign of the running
// diagonal) over the k leading nonzero columns, and the outputs: R = S
// R_tsqr, V's top rows = L (and their squares), and U^-1 for the apply pass.
__global__ void __launch_bounds__(kTreeThreads, 1) panel_tsqr_tree_kernel(
    float* __restrict__ V, float* __restrict__ R_out, TsqrScratch sc, int m,
    int b, int ntiles, int nblk, int ntree) {
  constexpr int NT = kTreeThreads;
  extern __shared__ __align__(16) unsigned char raw[];
  TsqrSmem<NT>& sm = *reinterpret_cast<TsqrSmem<NT>*>(raw);
  const int member = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ms = (long long)nblk * 32;
  float* S = sc.Rb + (size_t)member * nblk * kMat;
  double* Tm = sc.Ttree + (size_t)member * ntree * kMat;
  double* Cm = sc.Cb + (size_t)member * nblk * kMat;
  chain<NT>(sm, S, 32, S, 32, 32, ms, 0, ntree, Tm, tid);
  // the tree's Q from the top tile down: C = I, then per tile rows -Y T C
  // (C_c, rounded to float32 only for the row product) and C <- C - T C
  for (int e = tid; e < 32 * kLd; e += NT)
    sm.C[e] = (e / kLd == e % kLd) ? 1.0 : 0.0;
  for (int g = 0; g < ntree; ++g) {
    const long long r0 = (long long)g * kTreeTile;
    const int n = (int)min((long long)kTreeTile, ms - r0);
    load_mat<NT>(sm.T, Tm + (size_t)g * kMat, warp, lane);
    load_tile<NT>(sm.tile, S, 32, 32, r0, n, warp, lane);
    cp_async_wait_all();
    __syncthreads();
    mm32<NT>(sm.T, sm.C, sm.W, sm.Wf, 32, tid);
    __syncthreads();
    sub_w<NT>(sm.C, sm.W, tid);
    rows_times_w<NT>(sm.tile, sm.Wf, tid);
    __syncthreads();
    // the rows (C_c of the leaf chains; float32 products of the double C)
    for (int r = warp; r < n; r += NT / 32)
      Cm[(r0 + r) * 32 + lane] = sm.tile[r * kLd + lane];
    __syncthreads();
  }
  // Q1 = -Y_0[0:32] (T_0 C_0), the top tile of leaf chain 0 (Y_0's rows
  // staged in the tile buffer)
  load_mat<NT>(sm.T, sc.Tt + (size_t)member * ntiles * kMat, warp, lane);
  load_mat<NT>(sm.C, Cm, warp, lane);
  float* Vm = V + (size_t)member * m * b;
  for (int r = warp; r < 32; r += NT / 32)
    sm.tile[r * kLd + lane] = lane < b ? Vm[(size_t)r * b + lane] : 0.f;
  cp_async_wait_all();
  __syncthreads();
  mm32<NT>(sm.T, sm.C, sm.W, nullptr, 32, tid);
  __syncthreads();
  {
    constexpr int kOut = kMat / NT, kGroups = 32 / kOut;
    const int i = tid / kGroups, c0 = (tid % kGroups) * kOut;
    double acc[kOut];
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[q] = 0.0;
    for (int l = 0; l < 32; ++l) {
      const double y = sm.tile[i * kLd + l];
#pragma unroll
      for (int q = 0; q < kOut; ++q)
        acc[q] = fma(y, sm.W[l * 32 + c0 + q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kOut; ++q) sm.C[i * kLd + c0 + q] = -acc[q];
  }
  __syncthreads();
  if (warp == 0) {
    unsigned all = 0;
    for (int c = lane; c < nblk; c += 32)
      all |= sc.masks[(size_t)member * nblk + c];
    all = __reduce_or_sync(kFull, all);
    const int k = 32 - __clz(all);
    {
      // the LU, lane i holding row i of Q1; row j reaches the others by
      // shuffles; L\U back to sm.C
      double mr[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) mr[c] = sm.C[lane * kLd + c];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j >= k) break;
        const double q = __shfl_sync(kFull, mr[j], j);
        const double d = q >= 0.0 ? -1.0 : 1.0;
        const double u = q - d;                // |u| >= 1
        const double l = mr[j] * rcp64(u);
        if (lane == j) mr[j] = u;
        if (lane > j) mr[j] = l;
        if (lane == 0) sm.tau[j] = d;
#pragma unroll
        for (int c = j + 1; c < 32; ++c) {
          const double rjc = __shfl_sync(kFull, mr[c], j);
          if (lane > j && c < k) mr[c] = fma(-l, rjc, mr[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) sm.C[lane * kLd + c] = mr[c];
    }
    __syncwarp();
    // U^-1, lane c computing column c by back substitution from U's rows
    // in sm.C (zero outside the k x k block), into sm.T
    double xc[32];
#pragma unroll
    for (int i = 31; i >= 0; --i) {
      double acc = i == lane ? 1.0 : 0.0;
#pragma unroll
      for (int l2 = i + 1; l2 < 32; ++l2)
        acc = fma(-sm.C[i * kLd + l2], xc[l2], acc);
      xc[i] = (i < k && lane < k && i <= lane)
                  ? acc * rcp64(sm.C[i * kLd + i]) : 0.0;
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) sm.T[c * kLd + lane] = xc[c];
    if (lane == 0) {
      sm.kcols = k;
      sc.count[member] = 0;      // the apply pass's finishing counter
    }
  }
  __syncthreads();
  const int k = sm.kcols;
  store_mat<NT>(sc.Uinv + (size_t)member * kMat, sm.T, warp, lane);
  for (int e = tid; e < b * b; e += NT) {
    const int j = e / b, c = e % b;
    R_out[(size_t)member * b * b + e] =
        (j < k && c >= j && c < k)
            ? (float)(sm.tau[j] * sm.R[j * kLd + c]) : 0.f;
  }
  if (warp == 0) {                // V's top rows = L, column lane's squares
    double sq = 0.0;
    for (int i = 0; i < 32; ++i) {
      const float v = lane < k
          ? (i == lane ? 1.f : (i > lane ? (float)sm.C[i * kLd + lane] : 0.f))
          : 0.f;
      if (lane < b) Vm[(size_t)i * b + lane] = v;
      sq = fma((double)v, (double)v, sq);
    }
    sc.nrm_top[(size_t)member * 32 + lane] = sq;
  }
}

// The apply pass's shared memory (two blocks an SM).
struct __align__(16) ApplySmem {
  float Wf[kMat];               // T C' in float32 (read as float4)
  float tile[kTile * kLd];
  double T[32 * kLd];           // a tile's T; U^-1 at the start
  double C[32 * kLd];           // C'
  double W[kMat];               // T C'
  double nrm[kLeafThreads / 32][32];  // squares of V's columns, per warp
  int last;
};

// tile rows [first, n), every stride-th, to rows r0 + r of dst (row stride
// ld, ncols columns), skipping panel rows below `from`; returns the sum of
// the squares the lane stored (its column)
__device__ __forceinline__ double store_tile(const float* tile, float* dst,
                                             long long ld, int ncols,
                                             long long r0, int n, int first,
                                             int stride, int lane,
                                             long long from) {
  double sq = 0.0;
  for (int r = first; r < n; r += stride)
    if (lane < ncols && r0 + r >= from) {
      const float v = tile[r * kLd + lane];
      dst[(r0 + r) * ld + lane] = v;
      sq = fma((double)v, (double)v, sq);
    }
  return sq;
}

// Pass 2: chain blk of member blockIdx.y walks its tiles from the top with
// C' = C_c U^-1: per tile W = T C', V's rows = -Y W (below row 32; the tree
// kernel wrote L there), C' <- C' - W.  Each chain also sums the squares of
// the columns it wrote; the last chain to finish adds the chains' sums in
// order and writes tau_j = 2 / ||v_j||^2 (0 for a zero column).
__global__ void __launch_bounds__(kLeafThreads, 2) panel_tsqr_apply_kernel(
    float* __restrict__ V, float* __restrict__ tau_out, TsqrScratch sc,
    int m, int b, int tpb, int ntiles, int nblk) {
  constexpr int NT = kLeafThreads;
  extern __shared__ __align__(16) unsigned char raw[];
  ApplySmem& sm = *reinterpret_cast<ApplySmem*>(raw);
  const int member = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Vm = V + (size_t)member * m * b;
  const double* Tm = sc.Tt + (size_t)member * ntiles * kMat;
  load_mat<NT>(sm.T, sc.Uinv + (size_t)member * kMat, warp, lane);
  load_mat<NT>(sm.C, sc.Cb + ((size_t)member * nblk + blk) * kMat, warp,
               lane);
  cp_async_wait_all();
  __syncthreads();
  mm32<NT>(sm.C, sm.T, sm.W, nullptr, 32, tid);         // C_c U^-1
  __syncthreads();
  for (int e = tid; e < kMat; e += NT)
    sm.C[(e / 32) * kLd + e % 32] = sm.W[e];
  double sq = 0.0;
  const int g0 = blk * tpb, g1 = min(ntiles, g0 + tpb);
  for (int g = g0; g < g1; ++g) {
    const long long r0 = (long long)g * kTile;
    const int n = (int)min((long long)kTile, (long long)m - r0);
    load_mat<NT>(sm.T, Tm + (size_t)g * kMat, warp, lane);
    load_tile<NT>(sm.tile, Vm, b, b, r0, n, warp, lane);
    cp_async_wait_all();
    __syncthreads();
    mm32<NT>(sm.T, sm.C, sm.W, sm.Wf, 32, tid);
    __syncthreads();
    sub_w<NT>(sm.C, sm.W, tid);
    rows_times_w<NT>(sm.tile, sm.Wf, tid);
    __syncthreads();
    sq += store_tile(sm.tile, Vm, b, b, r0, n, warp, NT / 32, lane, 32);
    __syncthreads();
  }
  // the chain's squares, warps added in order; then the last chain's sum
  sm.nrm[warp][lane] = sq;
  __syncthreads();
  double* nrm = sc.nrm + (size_t)member * nblk * 32;
  if (warp == 0) {
    double s = 0.0;
    for (int k = 0; k < NT / 32; ++k) s += sm.nrm[k][lane];
    nrm[(size_t)blk * 32 + lane] = s;
    __threadfence();
    __syncwarp();
    if (lane == 0) sm.last = atomicAdd(sc.count + member, 1) == nblk - 1;
    __syncwarp();
    if (sm.last) {
      __threadfence();
      double tot = sc.nrm_top[(size_t)member * 32 + lane];
      for (int c = 0; c < nblk; ++c)
        tot += *(volatile double*)(nrm + (size_t)c * 32 + lane);
      if (lane < b) tau_out[(size_t)member * b + lane] =
          tot > 0.0 ? (float)(2.0 / tot) : 0.f;
    }
  }
}

// the opt-in past 48 KB of shared memory (and the carveout for two blocks
// an SM), once per kernel
template <typename K>
cudaError_t tsqr_smem_once(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e == cudaSuccess) *done = true;
  return e;
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

long long tsqr_scratch_bytes(int B, int ntiles, int nblk) {
  return (long long)tsqr_scratch(nullptr, nullptr, B, ntiles, nblk);
}

int tsqr_tile_rows() { return kTile; }

// Byte offset of the masks (B, nblk) in the scratch: which columns of each
// leaf chain hold a nonzero.
long long tsqr_masks_offset(int B, int ntiles, int nblk) {
  size_t nd, nf, ni;
  tsqr_counts(B, ntiles, nblk, &nd, &nf, &ni);
  return (long long)(nd * sizeof(double) + nf * sizeof(float));
}

// Pass 1 of the TSQR route: V (B, m, b) gets each leaf step's Y, the
// scratch (tsqr_scratch_bytes) the rest.  Leaf chain blk of a member factors
// tiles [blk * tpb, (blk + 1) * tpb) of ntiles = ceil(m / tile rows).
int panel_factor_tsqr_leaf(const float* src, long long lds, long long sbs,
                           float* V, void* scratch, int B, int m, int b,
                           int tpb, int ntiles, int nblk, void* stream) {
  static bool opted = false;
  if (b > kMaxB) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      tsqr_smem_once(panel_tsqr_leaf_kernel, sizeof(TsqrSmem<kLeafThreads>),
                     &opted);
  if (e != cudaSuccess) return (int)e;
  TsqrScratch sc;
  tsqr_scratch(&sc, (unsigned char*)scratch, B, ntiles, nblk);
  panel_tsqr_leaf_kernel<<<dim3(nblk, B), kLeafThreads,
                           sizeof(TsqrSmem<kLeafThreads>),
                           (cudaStream_t)stream>>>(src, lds, sbs, V, sc, m, b,
                                                   tpb, ntiles, nblk);
  return (int)cudaGetLastError();
}

// The rest of the TSQR route, for panels whose nonzero columns are leading:
// the tree and top block (R (B, b, b), V's top 32 rows), then the apply pass
// (V's other rows, tau (B, b)).
int panel_factor_tsqr_finish(float* V, float* tau, float* R, void* scratch,
                             int B, int m, int b, int tpb, int ntiles,
                             int nblk, void* stream) {
  static bool opted_tree = false, opted_apply = false;
  cudaError_t e =
      tsqr_smem_once(panel_tsqr_tree_kernel, sizeof(TsqrSmem<kTreeThreads>),
                     &opted_tree);
  if (e == cudaSuccess)
    e = tsqr_smem_once(panel_tsqr_apply_kernel, sizeof(ApplySmem),
                       &opted_apply);
  if (e != cudaSuccess) return (int)e;
  const int ntree = tsqr_trees(nblk);
  TsqrScratch sc;
  tsqr_scratch(&sc, (unsigned char*)scratch, B, ntiles, nblk);
  cudaStream_t st = (cudaStream_t)stream;
  panel_tsqr_tree_kernel<<<B, kTreeThreads, sizeof(TsqrSmem<kTreeThreads>),
                           st>>>(
      V, R, sc, m, b, ntiles, nblk, ntree);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  panel_tsqr_apply_kernel<<<dim3(nblk, B), kLeafThreads, sizeof(ApplySmem),
                            st>>>(V, tau, sc, m, b, tpb, ntiles, nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
