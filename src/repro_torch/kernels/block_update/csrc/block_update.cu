// Compact-WY trailing update A_out = A - V (T^T (V^T A)) (the TTD engine's
// "reflector application = two GEMMs on the GEMM array") for Hopper (sm_90a),
// plain C interface.
//
// Replaces the two Pallas kernels of src/repro/kernels/block_update/kernel.py
// (wy_update):
//   pass 1 (_vta_kernel, :28)  Y = V^T A, accumulated over M tiles
//   pass 2 (_update_kernel)    A_out = A - V W, W = T^T Y computed between
//                              the passes (torch.matmul in the wrapper, as
//                              XLA does it in the reference)
// Both take a leading batch (grid z) for the batched TT-SVD buckets.
//
// Pass 1.  The TPU kernel keeps the partial Y out of device memory by
// carrying it in VMEM along its sequential M-tile grid axis.  Here blocks
// run in no order: the grid splits M into chunks, each block writes the
// partial Y of its (chunk, column tile), and a second launch sums the
// partials in chunk order (deterministic, no atomics).
//   What bounds it: each row of A and V moved (4 (N + b) bytes) feeds
//   2 b N FLOPs.  At the largest main-path shape, 19,447,808 x 32 with
//   b = 32, that is 8 FLOPs a byte: 4.98 GB, 1.49 ms at 3.35 TB/s, against
//   0.59 ms of FP32 FMA, so bytes bound it by 2.5x.  At 24,576 x 2,784 bytes
//   and FMAs nearly balance (0.083 / 0.065 ms).  So the kernel has to keep
//   HBM busy and spend few instructions per FMA.
//   The design:
//   * A column tile that fits N: TN = 32 for N <= 32 (the Q formation of a
//     single 32-column panel, e.g. 19,447,808 x 32, where no lane idles) and
//     TN = 64 for N > 32 (every other trailing update and Q formation, up to
//     2,816 columns: each staged V row serves 64 columns).  The main path
//     reaches both widths; no other is compiled.
//   * A register tile with broadcast shared-memory reads: each of the 8
//     warps takes its own 8 of a stage's 64 rows and accumulates the block's
//     whole 32 x TN tile, 4 b-rows x TN/4 columns a lane.  For each row the
//     lanes read one 128-byte V row and TN/16 64-byte pieces of the A row as
//     16-byte loads: 32 FMAs per 3 loads at TN = 32, 64 per 5 at TN = 64.
//     At the end the warps' tiles are summed through shared memory in warp
//     order.
//   * Copies that overlap compute: a ring of kStages stages of 64 rows of V
//     (zero-padded to 32 columns) and A in dynamic shared memory, filled
//     with cp.async kStages - 1 stages ahead, one barrier per stage.  The
//     grid fills the 132 SMs at the occupancy the ring allows (3 blocks an
//     SM at TN = 32, 2 at TN = 64; ops.chunk_plan): 3 stages ahead of
//     16 KB (TN = 32) or 24 KB (TN = 64), up to 144 KB of copies in flight
//     per SM either way.
//   * Every input the contract allows, in one kernel templated on the copy
//     width: 16-byte copies when every row start of A and V is 16-byte
//     aligned (lda, the member stride and b multiples of 4, aligned bases:
//     the main path's trailing views, whose offsets are multiples of 32);
//     4-byte copies otherwise (e.g. lda = n + 5 at offset 5, or b = 13).
//     Rows past M and columns past N are zero-filled by the copy (its
//     source size), V's columns b..31 are zeroed once.
//   FP32 FFMA on the CUDA cores: no TF32 and no tensor cores (the reflector
//   application carries Q's orthogonality), no float atomics, so Y is the
//   same bit for bit from run to run.
// Pass 2 is a 64 x 64 output tile per block with V's rows and W's columns in
// shared memory.  A and the output may be strided row views of a larger
// matrix (the trailing block A[c0:, c1:] of blocked QR) and may alias:
// every element is read and written by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 32;      // panel width limit (rows of Y)
constexpr int kStageRows = 64; // rows of V and A per ring stage (pass 1)
constexpr int kStages = 4;     // ring depth (pass 1)
constexpr int kRowsPerWarp = kStageRows / kWarps;
constexpr int kLaneRows = 4;   // Y rows a lane accumulates (pass 1)
constexpr int kCols = 64;      // output columns per block (pass 2)
constexpr int kRows2 = 64;     // output rows per block (pass 2)

// floats of one ring stage: 64 rows of V (32 columns) and of A (TN columns)
template <int TN>
__host__ __device__ constexpr int stage_floats() {
  return kStageRows * (kMaxB + TN);
}

template <int TN>
__host__ __device__ constexpr int vta_smem_bytes() {
  return (int)sizeof(float) * kStages * stage_floats<TN>();
}

// blocks an SM runs: what the ring's shared memory allows; the launch
// bounds hold the registers to it
template <int TN>
__host__ __device__ constexpr int vta_min_blocks() {
  return TN == 32 ? 3 : 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0..16) from src and zero the rest of the 16 at dst
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// copy one float, or zero it when `bytes` is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r, r + 64) of the chunk (those below r1) into `stage`: V
// (64 x 32, columns >= b untouched) then A (64 x TN), kW floats a copy.
template <int TN, int kW>
__device__ __forceinline__ void load_stage(float* stage, const float* Vb,
                                           const float* Ab, long long lda,
                                           int r, int r1, int col0, int N,
                                           int b, int tid) {
  constexpr int kVPer = kMaxB / kW, kAPer = TN / kW;   // copies a row
  float* Vs = stage;
  float* As = stage + kStageRows * kMaxB;
  for (int e = tid; e < kStageRows * kVPer; e += kThreads) {
    const int rr = e / kVPer, c = kW * (e % kVPer);
    const int row = r + rr;
    if (c < b) {
      const bool in = row < r1;
      const float* src = in ? Vb + (size_t)row * b + c : Vb;
      if (kW == 4) cp_async16(Vs + rr * kMaxB + c, src, in ? 16 : 0);
      else cp_async4(Vs + rr * kMaxB + c, src, in ? 4 : 0);
    }
  }
  for (int e = tid; e < kStageRows * kAPer; e += kThreads) {
    const int rr = e / kAPer, c = kW * (e % kAPer);
    const int row = r + rr, col = col0 + c;
    const int bytes = row < r1 ? 4 * max(0, min(kW, N - col)) : 0;
    const float* src = bytes ? Ab + (size_t)row * lda + col : Ab;
    if (kW == 4) cp_async16(As + rr * TN + c, src, bytes);
    else cp_async4(As + rr * TN + c, src, bytes);
  }
}

// part[(chunk * B + batch) * b + i][col] = sum_{r in chunk} V[r, i] A[r, col]
// for the block's chunk of crows rows (a multiple of kStageRows) and its TN
// columns.  Lane (li, lj) = (lane / kLj, lane % kLj) holds Y rows kIR li ..
// kIR li + kIR - 1 and columns 4 (lj + kLj q) .. + 3, q < kQ.
template <int TN, int kW>
__global__ void __launch_bounds__(kThreads, vta_min_blocks<TN>())
    vta_partial_kernel(const float* __restrict__ V,
                       const float* __restrict__ A, long long lda,
                       long long sA, float* __restrict__ part, int B, int M,
                       int N, int b, int crows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = stage_floats<TN>();
  constexpr int kIR = kLaneRows;
  constexpr int kLj = 32 / (kMaxB / kIR);    // lanes along the columns
  constexpr int kQ = TN / (4 * kLj);         // float4 columns a lane
  static_assert(kWarps * kMaxB * TN <= kStages * kStage,
                "the warps' tiles must fit in the ring");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane / kLj, lj = lane % kLj;
  const int col0 = blockIdx.x * TN;
  const int chunk = blockIdx.y;
  const int batch = blockIdx.z;
  const int r0 = chunk * crows;
  const int r1 = min(M, r0 + crows);
  const int nsteps = (r1 - r0 + kStageRows - 1) / kStageRows;
  const float* Vb = V + (size_t)batch * M * b;
  const float* Ab = A + (size_t)batch * sA;
  if (b < kMaxB) {   // V's columns b..31 stay zero in every stage
    for (int e = tid; e < kStages * kStageRows * kMaxB; e += kThreads) {
      const int s = e / (kStageRows * kMaxB), o = e % (kStageRows * kMaxB);
      if (o % kMaxB >= b) smem[s * kStage + o] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      load_stage<TN, kW>(smem + s * kStage, Vb, Ab, lda, r0 + s * kStageRows,
                         r1, col0, N, b, tid);
    cp_async_commit();
  }
  float acc[kIR][4 * kQ];
#pragma unroll
  for (int i = 0; i < kIR; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kQ; ++c) acc[i][c] = 0.f;

  for (int k = 0; k < nsteps; ++k) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage k landed
    __syncthreads();                // everyone's; stage k - 1 is consumed
    const int next = k + kStages - 1;
    if (next < nsteps)
      load_stage<TN, kW>(smem + (next % kStages) * kStage, Vb, Ab, lda,
                         r0 + next * kStageRows, r1, col0, N, b, tid);
    cp_async_commit();
    const float* stage = smem + (k % kStages) * kStage;
    const float* Vs = stage + warp * kRowsPerWarp * kMaxB + kIR * li;
    const float* As = stage + kStageRows * kMaxB + warp * kRowsPerWarp * TN +
                      4 * lj;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float vv[kIR];
#pragma unroll
      for (int t = 0; t < kIR / 4; ++t) {
        const float4 v =
            *reinterpret_cast<const float4*>(Vs + rr * kMaxB + 4 * t);
        vv[4 * t] = v.x;
        vv[4 * t + 1] = v.y;
        vv[4 * t + 2] = v.z;
        vv[4 * t + 3] = v.w;
      }
      float4 a[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        a[q] = *reinterpret_cast<const float4*>(As + rr * TN + 4 * kLj * q);
#pragma unroll
      for (int i = 0; i < kIR; ++i) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          acc[i][4 * q + 0] = fmaf(vv[i], a[q].x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(vv[i], a[q].y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(vv[i], a[q].z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(vv[i], a[q].w, acc[i][4 * q + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free: reuse it
  float* mine = smem + warp * kMaxB * TN;
#pragma unroll
  for (int i = 0; i < kIR; ++i)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      *reinterpret_cast<float4*>(mine + (kIR * li + i) * TN + 4 * lj +
                                 4 * kLj * q) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                      acc[i][4 * q + 3]);
  __syncthreads();
  for (int e = tid; e < kMaxB * TN; e += kThreads) {
    const int i = e / TN, col = col0 + e % TN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[w * kMaxB * TN + e];
    if (i < b && col < N)
      part[((size_t)(chunk * B + batch) * b + i) * N + col] = s;
  }
}

// Y[batch, i, col] = sum of the chunks' partials, in chunk order; one thread
// per element of Y.
__global__ void vta_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ Y, int B, int N, int b,
                                  int nchunk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int batch = blockIdx.y;
  if (e >= b * N) return;
  const size_t stride = (size_t)B * b * N;
  const float* p = part + (size_t)batch * b * N + e;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < nchunk; ++c) s += p[c * stride];
  Y[(size_t)batch * b * N + e] = s;
}

// out[r, col] = A[r, col] - sum_i V[r, i] W[i, col]; A and out may alias.
__global__ void __launch_bounds__(kThreads) wy_apply_kernel(
    const float* A, long long lda, long long sA, const float* __restrict__ V,
    const float* __restrict__ W, float* out, long long ldo, long long sO,
    int M, int N, int b) {
  __shared__ float Vs[kRows2][kMaxB];
  __shared__ float Ws[kMaxB][kCols];
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;          // 0..3
  const int row0 = blockIdx.x * kRows2;
  const int col0 = blockIdx.y * kCols;
  const int batch = blockIdx.z;
  const float* Vb = V + (size_t)batch * M * b;
  const float* Wb = W + (size_t)batch * b * N;
  for (int e = tid; e < kRows2 * kMaxB; e += kThreads) {
    const int rr = e / kMaxB, i = e % kMaxB;
    const int r = row0 + rr;
    Vs[rr][i] = (r < M && i < b) ? Vb[(size_t)r * b + i] : 0.f;
  }
  for (int e = tid; e < kMaxB * kCols; e += kThreads) {
    const int i = e / kCols, cc = e % kCols;
    const int c = col0 + cc;
    Ws[i][cc] = (i < b && c < N) ? Wb[(size_t)i * N + c] : 0.f;
  }
  __syncthreads();
  const int col = col0 + tx;
  if (col >= N) return;
  const float* Ab = A + (size_t)batch * sA;
  float* Ob = out + (size_t)batch * sO;
  for (int k = 0; k < kRows2 / 4; ++k) {
    const int rr = ty + 4 * k;
    const int r = row0 + rr;
    if (r >= M) break;
    const float a = Ab[(size_t)r * lda + col];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxB; ++i) s += Vs[rr][i] * Ws[i][tx];
    Ob[(size_t)r * ldo + col] = a - s;
  }
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Allow the ring's dynamic shared memory (above the 48 KB default).
template <int TN, int kW>
cudaError_t prepare_vta() {
  return cudaFuncSetAttribute(vta_partial_kernel<TN, kW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              vta_smem_bytes<TN>());
}

template <int TN, int kW>
cudaError_t launch_vta(const float* V, const float* A, long long lda,
                       long long sA, float* part, int B, int M, int N, int b,
                       int crows, int nchunk, cudaStream_t st) {
  cudaError_t e = prepare_vta<TN, kW>();
  if (e != cudaSuccess) return e;
  const dim3 g(cdiv(N, TN), nchunk, B);
  vta_partial_kernel<TN, kW><<<g, kThreads, vta_smem_bytes<TN>(), st>>>(
      V, A, lda, sA, part, B, M, N, b, crows);
  return cudaGetLastError();
}

template <int TN, int kW>
cudaError_t occupancy(int* blocks) {
  cudaError_t e = prepare_vta<TN, kW>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vta_partial_kernel<TN, kW>, kThreads, vta_smem_bytes<TN>());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Pass 1.  V (B, M, b) contiguous, b <= 32; A rows of N floats at stride lda,
// members at stride sA; part scratch of nchunk * B * b * N floats; Y (B, b, N).
// Chunks are crows rows, a multiple of the stage's 64, and nchunk =
// ceil(M / crows) (ops.chunk_plan).  *wide is set to 1 when the 16-byte copy
// route ran, 0 for the 4-byte one.
int wy_vta(const float* V, const float* A, long long lda, long long sA,
           float* part, float* Y, int B, int M, int N, int b, int crows,
           int nchunk, int* wide, void* stream) {
  if (b < 1 || b > kMaxB || crows % kStageRows != 0 ||
      (long long)crows * nchunk < M || (long long)crows * (nchunk - 1) >= M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool w = lda % 4 == 0 && (B == 1 || sA % 4 == 0) && b % 4 == 0 &&
                 (uintptr_t)A % 16 == 0 && (uintptr_t)V % 16 == 0;
  *wide = w ? 1 : 0;
  cudaError_t e;
  if (N > 32)
    e = w ? launch_vta<64, 4>(V, A, lda, sA, part, B, M, N, b, crows, nchunk,
                              st)
          : launch_vta<64, 1>(V, A, lda, sA, part, B, M, N, b, crows, nchunk,
                              st);
  else
    e = w ? launch_vta<32, 4>(V, A, lda, sA, part, B, M, N, b, crows, nchunk,
                              st)
          : launch_vta<32, 1>(V, A, lda, sA, part, B, M, N, b, crows, nchunk,
                              st);
  if (e != cudaSuccess) return (int)e;
  const dim3 g2(cdiv((long long)b * N, 256), B);
  vta_reduce_kernel<<<g2, 256, 0, st>>>(part, Y, B, N, b, nchunk);
  return (int)cudaGetLastError();
}

// Pass 1's layout, for checking ops.py against it: the stage rows, the ring
// depth, the column tile and the blocks an SM runs for a problem of N
// columns on the route `wide` (1: 16-byte copies).
int wy_vta_layout(int N, int wide, int* stage_rows, int* stages, int* tile,
                  int* blocks_per_sm) {
  *stage_rows = kStageRows;
  *stages = kStages;
  *tile = N > 32 ? 64 : 32;
  cudaError_t e;
  if (N > 32)
    e = wide ? occupancy<64, 4>(blocks_per_sm)
             : occupancy<64, 1>(blocks_per_sm);
  else
    e = wide ? occupancy<32, 4>(blocks_per_sm)
             : occupancy<32, 1>(blocks_per_sm);
  return (int)e;
}

// Pass 2.  out = A - V W with W (B, b, N) contiguous; out rows at stride ldo,
// members at stride sO (out may be A itself).
int wy_apply(const float* A, long long lda, long long sA, const float* V,
             const float* W, float* out, long long ldo, long long sO, int B,
             int M, int N, int b, void* stream) {
  if (b > kMaxB) return (int)cudaErrorInvalidValue;
  const dim3 g(cdiv(M, kRows2), cdiv(N, kCols), B);
  wy_apply_kernel<<<g, kThreads, 0, (cudaStream_t)stream>>>(
      A, lda, sA, V, W, out, ldo, sO, M, N, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
