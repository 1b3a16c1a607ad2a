// Compact-WY trailing update A_out = A - V (T^T (V^T A)) (the TTD engine's
// "reflector application = two GEMMs on the GEMM array") for Hopper (sm_90a),
// plain C interface.
//
// Replaces the two Pallas kernels of src/repro/kernels/block_update/kernel.py
// (wy_update):
//   pass 1 (_vta_kernel)     Y = V^T A, accumulated over M tiles
//   pass 2 (_update_kernel)  A_out = A - V W, W = T^T Y computed between the
//                            passes (torch.matmul in the wrapper, as XLA does
//                            it in the reference)
// Both take a leading batch (grid z) for the batched TT-SVD buckets.
//
// The TPU kernel carries Y across its sequential M-tile grid axis in VMEM.
// Here blocks run in no order, so pass 1 splits M into chunks: each block
// writes the partial Y of its (chunk, 64 columns) tile, and a second launch
// sums the partials in chunk order (deterministic, no atomics).  Pass 2 is a
// 64 x 64 output tile per block with V's rows and W's columns in shared
// memory.  A and the output may be strided row views of a larger matrix (the
// trailing block A[c0:, c1:] of blocked QR) and may alias: every element is
// read and written by one thread.  f32 FFMA on the CUDA cores (no TF32).
// With b = 32 each pass does 2 b = 64 FLOPs per 8 bytes of A moved, so at
// the trailing matrices of TT-SVD the passes are bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxB = 32;      // panel width limit (rows of Y)
constexpr int kCols = 64;      // output columns per block (both passes)
constexpr int kRowTile = 32;   // A rows staged per step (pass 1)
constexpr int kRows2 = 64;     // output rows per block (pass 2)

// part[(chunk * B + batch) * b + i][col] = sum_{r in chunk} V[r, i] A[r, col]
__global__ void __launch_bounds__(kThreads) vta_partial_kernel(
    const float* __restrict__ V, const float* __restrict__ A, long long lda,
    long long sA, float* __restrict__ part, int B, int M, int N, int b,
    int crows) {
  __shared__ float As[kRowTile][kCols];
  __shared__ float Vs[kRowTile][kMaxB];
  const int tid = threadIdx.x;
  const int tx = tid % kCols;          // column in the tile
  const int ty = tid / kCols;          // 0..3: Y rows ty*8 .. ty*8+7
  const int col0 = blockIdx.x * kCols;
  const int chunk = blockIdx.y;
  const int batch = blockIdx.z;
  const int r0 = chunk * crows;
  const int r1 = min(M, r0 + crows);
  const float* Vb = V + (size_t)batch * M * b;
  const float* Ab = A + (size_t)batch * sA;
  float acc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = 0.f;
  for (int rt = r0; rt < r1; rt += kRowTile) {
    for (int e = tid; e < kRowTile * kCols; e += kThreads) {
      const int rr = e / kCols, cc = e % kCols;
      const int r = rt + rr, c = col0 + cc;
      As[rr][cc] = (r < r1 && c < N) ? Ab[(size_t)r * lda + c] : 0.f;
    }
    for (int e = tid; e < kRowTile * kMaxB; e += kThreads) {
      const int rr = e / kMaxB, i = e % kMaxB;
      const int r = rt + rr;
      Vs[rr][i] = (r < r1 && i < b) ? Vb[(size_t)r * b + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kRowTile; ++rr) {
      const float a = As[rr][tx];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] += Vs[rr][ty * 8 + q] * a;
    }
    __syncthreads();
  }
  const int col = col0 + tx;
  if (col >= N) return;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = ty * 8 + q;
    if (i < b) part[((size_t)(chunk * B + batch) * b + i) * N + col] = acc[q];
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

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Pass 1.  V (B, M, b) contiguous, b <= 32; A rows of N floats at stride lda,
// members at stride sA; part scratch of nchunk * B * b * N floats; Y (B, b, N).
// Chunks are crows rows (a multiple of 32); nchunk = ceil(M / crows).
int wy_vta(const float* V, const float* A, long long lda, long long sA,
           float* part, float* Y, int B, int M, int N, int b, int crows,
           int nchunk, void* stream) {
  if (b > kMaxB) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g1(cdiv(N, kCols), nchunk, B);
  vta_partial_kernel<<<g1, kThreads, 0, st>>>(V, A, lda, sA, part, B, M, N, b,
                                              crows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2(cdiv((long long)b * N, 256), B);
  vta_reduce_kernel<<<g2, 256, 0, st>>>(part, Y, B, N, b, nchunk);
  return (int)cudaGetLastError();
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
