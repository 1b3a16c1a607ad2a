// Flash attention (prefill) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel of src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _flash_kernel, reached through ops.mha_flash): causal,
// optionally windowed attention with an online softmax in float32.
//   * scores are q . k * sm_scale (D^-1/2);
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
// Two routes, one per input type.
//
// bfloat16 (flash_attention_mma_bf16): the tensor-core kernel.  Bound: at
// the hybrid path's shape (B 2, S 4,096, 10 Q heads / 1 KV head, D 256,
// window 2,048) the work is 1.29e11 FLOPs against 92 MB of traffic, so it is
// bound by operations: 0.130 ms at the tensor cores' bf16 rate.  Design:
//   * one block per (128 query rows, head, batch row); each of its 8 warps
//     owns 16 query rows (64-row blocks of 4 warps measured slower at the
//     path's shape); the query-tile index is the slowest grid dimension and
//     runs backwards, so the heaviest tiles (full window, or the last rows
//     under a causal mask) start first;
//   * Q K^T and P V are mma.sync.m16n8k16 with bf16 operands and float32
//     accumulators; operands come from shared memory through ldmatrix
//     (.trans for V); Q stays in shared memory and is re-read per k-step;
//   * 64-key K/V tiles are double-buffered with 16-byte cp.async.cg copies
//     (rows >= S zero-filled); shared rows are XOR-swizzled on 16-byte
//     chunks so that the eight rows an ldmatrix reads hit eight bank groups;
//   * the online softmax stays in the warp: each thread holds two rows'
//     m and l (partial l, summed over the quad at the end), row maxima are
//     taken with quad shuffles; the scale D^-1/2 * log2(e) is applied to the
//     float32 scores and exp2f is used; P is rounded to bf16 in registers
//     (the score accumulator becomes the A fragment of P V), l is summed
//     from the same float32 p, the 16 x D float32 output accumulator is
//     rescaled by alpha every tile;
//   * masks are computed only on tiles that straddle the diagonal, the
//     window edge or S; a warp skips a tile wholly masked for its rows;
//   * O / l goes to bf16, through the warp's own (dead) rows of the Q tile,
//     out as coalesced 16-byte stores; rows >= S are never written.
// At D = 256: 192 KB of shared memory, one block per SM.
//
// float32 (flash_attention_f32): the tensor-core kernel in 3xTF32.  Bound:
// the same 1.29e11 FLOPs against 185 MB; on FFMA (67 TFLOP/s) 1.92 ms, as
// three TF32 products per float32 product at the tensor cores' 495 TFLOP/s
// 0.78 ms.  Design:
//   * every float32 operand x is split into hi = rna_tf32(x) and lo =
//     rna_tf32(x - hi) (integer rounding, 5 instructions a split); a
//     product takes hi*hi + hi*lo + lo*hi on
//     mma.sync.m16n8k8 tf32 with float32 accumulators (lo*lo, below 2^-22
//     of the product, is dropped), for Q K^T and for P V, P split in
//     registers; Q K^T keeps hi*hi and the two small products in separate
//     accumulators; the output is rescaled only when a row's max moved;
//   * P V is not summed across key tiles in the tensor cores' accumulators,
//     which round toward zero (a bias of ~1e-5 of |o| over a row's 864 mma
//     steps at D = 256): each 8-key group's products (D = 256), or a key
//     tile's (D <= 128, where the per-group form spills), go into a zeroed
//     fragment added to O with round-to-nearest adds;
//   * one block per (query rows, head, batch row), warps of 16 rows,
//     heaviest query tiles first: 4 warps and 32-key K/V tiles up to D =
//     128, 8 warps and 16-key tiles at D = 256 (F32Tile); K/V tiles
//     double-buffered with 16-byte cp.async.cg copies (rows >= S
//     zero-filled); Q, K and V stay in float32 in shared memory, rows
//     padded against bank conflicts, and are split as they are read;
//   * the contraction orders are permuted so that every fragment read is
//     16 bytes a lane and P's A fragment is the score accumulator itself
//     (no shuffle, no trip through shared memory): see the kernel;
//   * the online softmax in the warp with quad shuffles, base 2, as the
//     bf16 route; masks only on tiles that straddle the diagonal, the
//     window edge or S; a warp skips a tile wholly masked for its rows;
//   * O / l stored straight from the accumulators, 16 bytes a lane, a
//     quad's 128 bytes contiguous; rows >= S are never written.
// At D = 256: 207,360 bytes of shared memory, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // key rows per tile (bf16 route)
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (mma.sync m16n8k16, ldmatrix, cp.async)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> float32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Shared tiles hold D bf16 per row as D / 8 chunks of 16 bytes.  A row's
// chunk index is XORed with swz_bits(row) so that the eight rows one
// ldmatrix phase reads (same logical chunk) land in eight different 16-byte
// bank groups: row % 8 for D >= 64; for D = 32 (four chunks a row, two rows
// per 128 bytes) (row / 2) % 4.  Rows 16 apart share their bits, and the
// XOR touches only a chunk index's low three bits, so chunk 8 j + c of row
// 16 i + r sits at a fixed per-lane offset (r, c < 8) plus an immediate.
template <int D>
__device__ __forceinline__ int swz_bits(int row) {
  return D >= 64 ? (row & 7) : ((row >> 1) & 3);
}

template <int D>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (D / 8) + (chunk ^ swz_bits<D>(row))) * 16u;
}

constexpr int kWarps = 8;              // warps per block, 16 query rows each
constexpr int kMmaRows = 16 * kWarps;  // query rows per block

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q (kMmaRows x D) and two stages of K and V (kBK x D each), bf16
  return ((size_t)kMmaRows * D + (size_t)4 * kBK * D) * 2;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32, 1) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
    int Hq, int Hkv, int causal, int window, float scale_log2) {
  constexpr int NT = kWarps * 32;
  constexpr int BQ = kMmaRows;
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int TILE = kBK * D;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* skv = sq + BQ * D;  // stage s: K at 2s*TILE, V after it

  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_row = (size_t)Hq * D;
  const size_t kv_row = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  __nv_bfloat16* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  // keys [kv_begin, kv_end) can be live for some row of this block
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  // copies: each thread takes chunk lc of rows lr, lr + RPP, ...; rows past
  // S read row S - 1 with a source size of 0, which writes zeros
  constexpr int RPP = NT / CPR;  // rows per pass
  static_assert(NT % CPR == 0 && kBK % RPP == 0 && BQ % RPP == 0, "tiling");
  const int lr = tid / CPR, lc = tid % CPR;
  const uint32_t sq_u = smem_addr(sq);
  const uint32_t skv_u = smem_addr(skv);
#pragma unroll
  for (int p = 0; p < BQ / RPP; ++p) {
    const int r = lr + p * RPP;
    cp_async16(sq_u + swz<D>(r, lc),
               qb + (size_t)min(q0 + r, S - 1) * q_row + lc * 8, q0 + r < S);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBK;
    const uint32_t sk_u = skv_u + stage * 2 * TILE * 2;
#pragma unroll
    for (int p = 0; p < kBK / RPP; ++p) {
      const int r = lr + p * RPP;
      const size_t off = (size_t)min(k0 + r, S - 1) * kv_row + lc * 8;
      cp_async16(sk_u + swz<D>(r, lc), kb + off, k0 + r < S);
      cp_async16(sk_u + TILE * 2 + swz<D>(r, lc), vb + off, k0 + r < S);
    }
  };
  load_kv(t_begin, 0);
  cp_async_commit();

  // this warp's rows [qw, qw + 16); thread holds rows g and g + 8 of them
  const int qw = q0 + warp * 16;
  const int g = lane / 4;
  const int t4 = lane % 4;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  // ldmatrix addresses of this lane (fragment layouts: Q as A, 16 rows x
  // 16 d; K as B, 16 keys x 16 d; V as B^T, 16 keys x 16 d): the row's
  // offset plus the swizzled offset of k-step (or d-pair) i % 4; step i
  // adds 128 (i / 4) bytes, key group n adds n rows
  const int qa_row = warp * 16 + (lane % 16);
  const int kb_row = (lane % 8) + (lane / 16) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8;
  uint32_t qa_u[4], kb_off[4], vb_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qa_u[i] = sq_u + swz<D>(qa_row, 2 * i + lane / 16);
    kb_off[i] = swz<D>(kb_row, 2 * i + (lane / 8) % 2);
    vb_off[i] = swz<D>(vb_row, 2 * i + lane / 16);
  }
  constexpr uint32_t ROW16 = 16 * CPR * 16;  // bytes of 16 rows

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
    }
    const int k0 = t * kBK;
    // skip a tile wholly masked for this warp's rows (exact: its weights
    // would be 0, or 1 and then wiped by alpha = 0)
    if (qw >= S || (causal && k0 > qw + 15) ||
        (window > 0 && qw - (k0 + kBK - 1) >= window))
      continue;
    const uint32_t sk_u = skv_u + stage * 2 * TILE * 2;
    const uint32_t sv_u = sk_u + TILE * 2;

    // S = Q K^T: 16 rows x 64 keys, eight 16 x 8 accumulators
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(qa_u[ks % 4] + 128 * (ks / 4), a);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t kf[4];
        ldsm_x4(sk_u + kb_off[ks % 4] + nb * ROW16 + 128 * (ks / 4), kf);
        mma_bf16(s[2 * nb], a, kf[0], kf[1]);
        mma_bf16(s[2 * nb + 1], a, kf[2], kf[3]);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    if ((causal && k0 + kBK - 1 > qw) ||
        (window > 0 && qw + 15 - k0 >= window) || k0 + kBK > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qw + g + (e >= 2 ? 8 : 0);
          const int kr = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kr >= S)
            s[j][e] = -INFINITY;  // past the sequence: never weighted
          else if ((causal && kr > qr) || (window > 0 && qr - kr >= window))
            s[j][e] = kMasked;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float al0 = exp2f(m0 - mx0);
    const float al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P in bf16 as the A fragments of P V (16 rows x 16 keys each)
    uint32_t pa[4][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mx0);
      const float p1 = exp2f(s[j][1] - mx0);
      const float p2 = exp2f(s[j][2] - mx1);
      const float p3 = exp2f(s[j][3] - mx1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: 16 rows x D, D / 8 accumulators of 16 x 8
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vf[4];
        ldsm_x4_trans(sv_u + vb_off[nd % 4] + kk * ROW16 + 128 * (nd / 4),
                      vf);
        mma_bf16(acc[2 * nd], pa[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * nd + 1], pa[kk], vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();
  if (qw >= S) return;

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  // stage O / l in this warp's own rows of the Q tile (only this warp read
  // them), then store 16-byte chunks, neighbouring lanes on one row
  unsigned char* so = smem_raw;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(so + swz<D>(r0, n) + 4 * t4) =
        pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    *reinterpret_cast<uint32_t*>(so + swz<D>(r0 + 8, n) + 4 * t4) =
        pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    if (qw + r < S)
      *reinterpret_cast<uint4*>(ob + (size_t)(qw + r) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(so + swz<D>(warp * 16 + r, c));
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Hq, int Hkv, int causal, int window, float scale,
               void* stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hq, (S + kMmaRows - 1) / kMmaRows);
  flash_mma_kernel<D><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, S, Hq, Hkv, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: tensor-core kernel, 3xTF32 (mma.sync m16n8k8 tf32, cp.async)
// ---------------------------------------------------------------------------

// The tiles by head dim: WARPS warps of 16 query rows a block, BK keys a
// K/V tile.  Up to D = 128, 4 warps and 32 keys, and two or more blocks
// share an SM; at D = 256 the 16 x 256 accumulator takes ~240 registers, so
// an SM holds one block, and 8 warps with 16-key tiles (the shared memory
// of 128 rows of Q) give each scheduler two warps (on an H100 at the
// path's shape 4 warps of 32 keys took 2.81 ms, 8 of 16 2.66 ms; PERF.md).
template <int D>
struct F32Tile {
  static constexpr int WARPS = D == 256 ? 8 : 4;
  static constexpr int BQ = 16 * WARPS;  // query rows per block
  static constexpr int BK = D == 256 ? 16 : 32;
  // rows padded so that the fragment reads (16 bytes a lane) are free of
  // bank conflicts: Q and K rows by 16 floats (the eight lanes of a phase
  // read rows g, g + 1 at d 4 t: chunks 4 g + t mod 8), V rows by 4 (rows
  // 2 t, 2 t + 1 at d 4 g: chunks 2 t + g mod 8)
  static constexpr int QS = D + 16;  // Q and K row stride, floats
  static constexpr int VS = D + 4;   // V row stride
  static constexpr int K_FLOATS = BK * QS;
  static constexpr int STAGE = K_FLOATS + BK * VS;  // a K and a V tile
  static constexpr size_t BYTES =
      ((size_t)BQ * QS + 2 * (size_t)STAGE) * sizeof(float);
};

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero:
// half a tf32 ulp added to the bits, the 13 low bits cleared.  For finite
// x this is cvt.rna.tf32.f32, which ptxas expands to 4-5 instructions (its
// NaN and overflow handling) where this takes 2: the kernel at D = 256
// went from 9,256 to 7,288 instructions, 4.18 to 2.81 ms on an H100
// (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + r, hi and lo tf32, |r| <= 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major), tf32 -> float32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::WARPS * 32, 1)
    flash_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int Hq,
    int Hkv, int causal, int window, float scale_log2) {
  using T = F32Tile<D>;
  constexpr int NT = T::WARPS * 32;
  constexpr int BQ = T::BQ;
  constexpr int BK = T::BK;
  constexpr int NJ = BK / 8;  // key groups (8 keys) a tile
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  extern __shared__ __align__(16) float smem_f[];
  float* sq = smem_f;
  float* skv = sq + BQ * T::QS;  // stage s: K at s * STAGE, V after it

  const int h = blockIdx.x % Hq;
  const int b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const size_t q_row = (size_t)Hq * D;
  const size_t kv_row = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  float* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  // keys [kv_begin, kv_end) can be live for some row of this block
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  // copies: each thread takes chunk lc of rows lr, lr + RPP, ...; rows past
  // S read row S - 1 with a source size of 0, which writes zeros
  constexpr int RPP = NT / CPR;  // rows per pass
  static_assert(NT % CPR == 0 && BK % RPP == 0 && BQ % RPP == 0, "tiling");
  const int lr = tid / CPR, lc = tid % CPR;
  const uint32_t sq_u = smem_addr(sq);
  const uint32_t skv_u = smem_addr(skv);
#pragma unroll
  for (int p = 0; p < BQ / RPP; ++p) {
    const int r = lr + p * RPP;
    cp_async16(sq_u + (r * T::QS + lc * 4) * 4,
               qb + (size_t)min(q0 + r, S - 1) * q_row + lc * 4, q0 + r < S);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    const uint32_t sk_u = skv_u + stage * T::STAGE * 4;
    const uint32_t sv_u = sk_u + T::K_FLOATS * 4;
#pragma unroll
    for (int p = 0; p < BK / RPP; ++p) {
      const int r = lr + p * RPP;
      const size_t off = (size_t)min(k0 + r, S - 1) * kv_row + lc * 4;
      cp_async16(sk_u + (r * T::QS + lc * 4) * 4, kb + off, k0 + r < S);
      cp_async16(sv_u + (r * T::VS + lc * 4) * 4, vb + off, k0 + r < S);
    }
  };
  load_kv(t_begin, 0);
  cp_async_commit();

  // this warp's rows [qw, qw + 16); the thread holds rows g and g + 8
  const int qw = q0 + warp * 16;
  const int g = lane / 4;
  const int t4 = lane % 4;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  // Fragment orders.  Q K^T sums over d in any order shared by Q and K: the
  // two k-steps of d block c (16 wide) take d 16 c + 4 t4 + (0, 1) as k (t4,
  // t4 + 4) and + (2, 3) as the next step's, so one 16-byte read of a Q or
  // K row feeds both.  P V sums over keys in any order shared by P and V:
  // key group j is a k-step with k t4 <-> key 8 j + 2 t4 and k t4 + 4 <->
  // key 8 j + 2 t4 + 1, which is where S's accumulator holds them, so P's A
  // fragment is the accumulator (c0, c2, c1, c3) with no shuffle.  Output
  // column n of d tile 4 a + i is d 32 a + 4 n + i, so a lane reads V at d
  // 32 a + 4 g (16 bytes for four tiles) and holds O at 32 a + 8 t4 + (0..7).
  const float* qf = sq + (warp * 16 + g) * T::QS + 4 * t4;
  const int kf_off = g * T::QS + 4 * t4;
  const int vf_off = 2 * t4 * T::VS + 4 * g;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
    }
    const int k0 = t * BK;
    // skip a tile wholly masked for this warp's rows (exact: its weights
    // would be 0, or 1 and then wiped by alpha = 0)
    if (qw >= S || (causal && k0 > qw + 15) ||
        (window > 0 && qw - (k0 + BK - 1) >= window))
      continue;
    const float* sk = skv + stage * T::STAGE;
    const float* sv = sk + T::K_FLOATS;

    // S = Q K^T: 16 rows x BK keys, NJ 16 x 8 tiles; hi*hi into sb,
    // hi*lo + lo*hi into ss (lo*lo, below 2^-22 of the product, dropped)
    float sb[NJ][4], ss[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[j][e] = ss[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(qf + 16 * c);
      const float4 x1 =
          *reinterpret_cast<const float4*>(qf + 8 * T::QS + 16 * c);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x0.x, ah[0][0], al[0][0]);
      split_tf32(x1.x, ah[0][1], al[0][1]);
      split_tf32(x0.y, ah[0][2], al[0][2]);
      split_tf32(x1.y, ah[0][3], al[0][3]);
      split_tf32(x0.z, ah[1][0], al[1][0]);
      split_tf32(x1.z, ah[1][1], al[1][1]);
      split_tf32(x0.w, ah[1][2], al[1][2]);
      split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(
            sk + kf_off + 8 * j * T::QS + 16 * c);
        uint32_t bh[4], bl[4];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        split_tf32(y.z, bh[2], bl[2]);
        split_tf32(y.w, bh[3], bl[3]);
        mma_tf32(ss[j], al[0], bh[0], bh[1]);
        mma_tf32(ss[j], ah[0], bl[0], bl[1]);
        mma_tf32(sb[j], ah[0], bh[0], bh[1]);
        mma_tf32(ss[j], al[1], bh[2], bh[3]);
        mma_tf32(ss[j], ah[1], bl[2], bl[3]);
        mma_tf32(sb[j], ah[1], bh[2], bh[3]);
      }
    }
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = (sb[j][e] + ss[j][e]) * scale_log2;
    if ((causal && k0 + BK - 1 > qw) ||
        (window > 0 && qw + 15 - k0 >= window) || k0 + BK > S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = qw + g + (e >= 2 ? 8 : 0);
          const int kr = k0 + 8 * j + 2 * t4 + (e & 1);
          if (kr >= S)
            s[j][e] = -INFINITY;  // past the sequence: never weighted
          else if ((causal && kr > qr) || (window > 0 && qr - kr >= window))
            s[j][e] = kMasked;
        }
    }

    // online softmax, rows g (e = 0, 1) and g + 8 (e = 2, 3), base 2
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float al0 = exp2f(m0 - mx0);
    const float al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    // rescale only when some row's max moved (alpha = 1 changes nothing)
    if (__any_sync(kFull, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
    }

    // O += P V: 16 rows x D, D / 8 accumulators of 16 x 8.  The tensor
    // cores' accumulator rounds toward zero, so the products go into a
    // zeroed fragment that is added to O with round-to-nearest adds: the
    // truncation stays inside the fragment's few steps and the sum over the
    // row's key tiles is unbiased.  At D = 256 (NJ = 2) a fragment takes one
    // 8-key group (its three products, small ones first); below, where that
    // form spills at D = 128 (4 groups a tile), one fragment per output tile
    // takes the whole key tile, the key groups innermost, P split once
    if constexpr (NJ <= 2) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = sv + vf_off + 8 * j * T::VS;
#pragma unroll
        for (int a = 0; a < D / 32; ++a) {
          const float4 v0 = *reinterpret_cast<const float4*>(vr + 32 * a);
          const float4 v1 =
              *reinterpret_cast<const float4*>(vr + T::VS + 32 * a);
          const float w0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(w0[i], bh0, bl0);
            split_tf32(w1[i], bh1, bl1);
            float f[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(f, pl, bh0, bh1);
            mma_tf32(f, ph, bl0, bl1);
            mma_tf32(f, ph, bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * a + i][e] += f[e];
          }
        }
      }
    } else {
      uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split_tf32(s[j][0], ph[j][0], pl[j][0]);
        split_tf32(s[j][2], ph[j][1], pl[j][1]);
        split_tf32(s[j][1], ph[j][2], pl[j][2]);
        split_tf32(s[j][3], ph[j][3], pl[j][3]);
      }
#pragma unroll
      for (int a = 0; a < D / 32; ++a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float* vr = sv + vf_off + 8 * j * T::VS + 32 * a + i;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(vr[0], bh0, bl0);
            split_tf32(vr[T::VS], bh1, bl1);
            mma_tf32(f, pl[j], bh0, bh1);
            mma_tf32(f, ph[j], bl0, bl1);
            mma_tf32(f, ph[j], bh0, bh1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * a + i][e] += f[e];
        }
      }
    }
  }
  cp_async_wait_all();
  if (qw >= S) return;

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  // the lane holds d 32 a + 8 t4 + (0..7) of rows g and g + 8: two 16-byte
  // stores each, a quad's 128 bytes contiguous; rows >= S are not written
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qr = qw + g + 8 * half;
    if (qr >= S) continue;
    const float l = half ? l1 : l0;
    float* orow = ob + (size_t)qr * q_row + 8 * t4;
#pragma unroll
    for (int a = 0; a < D / 32; ++a) {
      const int e = 2 * half;
      *reinterpret_cast<float4*>(orow + 32 * a) =
          make_float4(acc[4 * a][e] / l, acc[4 * a + 1][e] / l,
                      acc[4 * a + 2][e] / l, acc[4 * a + 3][e] / l);
      *reinterpret_cast<float4*>(orow + 32 * a + 4) = make_float4(
          acc[4 * a][e + 1] / l, acc[4 * a + 1][e + 1] / l,
          acc[4 * a + 2][e + 1] / l, acc[4 * a + 3][e + 1] / l);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Hq, int Hkv, int causal, int window, float scale,
               void* stream) {
  using T = F32Tile<D>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hq, (S + T::BQ - 1) / T::BQ);
  flash_tf32x3_kernel<D><<<grid, T::WARPS * 32, T::BYTES,
                           (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, Hq,
      Hkv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q, o (B, S, Hq, D); k, v (B, S, Hkv, D); contiguous, on the device, all
// float32.  D in {32, 64, 128, 256}; Hq % Hkv == 0; window <= 0 means none.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int D, int causal,
                        int window, float scale, void* stream) {
  switch (D) {
    case 32:
      return launch_f32<32>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 64:
      return launch_f32<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 128:
      return launch_f32<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                             stream);
    case 256:
      return launch_f32<256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same contract in bfloat16, every pointer 16-byte aligned.
int flash_attention_mma_bf16(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int Hq, int Hkv, int D,
                             int causal, int window, float scale,
                             void* stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                             stream);
    case 256:
      return launch_mma<256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
