// Fused TT-chain kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of src/repro/kernels/tt_contract/kernel.py:
//   tt_contract_2  (_tt2_kernel)   y = (x . g0) . g1
//   tt_contract_3  (_tt3_kernel)   3-core chain, split 1 (expand) or 2 (contract)
//   tt_contract_2q / tt_contract_3q (_tt2q_kernel, _tt3q_kernel): the same with
//   int8 cores, widened in registers, and the product of the scales applied
//   once to the output
// and the expert-batched chain of src/repro/kernels/tt_contract/ops.py
// (tt_contract_batched, a jax.vmap of the four over the expert axis), together
// with the lead absorption that src/repro/core/tt_linear.py (tt_apply,
// tt_apply_experts) runs in jnp before them.
//
// One call computes y = x . W for a TTLinear from its STORED tensors: the
// lead row (r_s,) of the selected layer, or (E, r_s) for an expert bank, the
// first core (r_s, n1, r1), the tail cores, and the scales of a quantized
// leaf.  Nothing is absorbed or cast beforehand: W's first core is
// sum_s lead[s] g0[s], formed on the chip while g0 streams past.  The
// absorbed-chain API is the case r_s = 1 with no lead (a null pointer), a
// float32 first core per expert (a first-core expert stride) for the batched
// one.  Two launches around the chain's narrowest rank:
//
//   phase A  the input side: absorb the lead into the first core and
//            contract it with x into the rank vector t (E, B, R).  The grid
//            splits the contracted mode into chunks so that the stored first
//            core, which is most of the bytes, is read once, spread over the
//            SMs.  Three routes:
//     absorb_in_kernel  split 1, one chain (or per-expert first cores): the
//            lead is a vector, so the absorption is one FMA per stored
//            element (memory-bound); FFMA.  Slabs (8 s x 16 k rows x 32
//            rank columns) stream through a ring of shared-memory stages
//            with 16-byte cp.async, the k sub-tile's x rows riding with its
//            last stage; the absorbed 16 x 32 tile meets x (64 rows a block,
//            read 4 at a time) in registers.
//     bank_kernel  split 1, an expert bank (64 lead rows a block): the
//            absorption (E x r_s) . (r_s x n1 r1) is a GEMM; bf16 on
//            mma.sync m16n8k16 with float32 accumulation (bf16 x bf16 is
//            exact in float32), int8 on m16n8k32 with s32 accumulation (exact),
//            float32 on FFMA with the same fragment layout (no TF32).  A
//            block owns 256 flat (k, r) columns (whole k rows or not), so its
//            rows of g0 stay on 16-byte boundaries and the fragments come from
//            ldmatrix (lead rows) and ldmatrix.trans (bf16 g0 rows) where the
//            sizes allow.  The epilogue multiplies each column of the result
//            by x[e, c, k] and sums the columns of each rank r into the
//            block's partial: the absorbed bank never reaches device memory.
//     contract2_kernel  split 2: the first core is small; each block absorbs
//            it into shared memory in a prologue (its slabs streaming through
//            a cp.async ring), then streams over i2 and the r1 columns.
//            absorb_in and contract2 end with an integer ticket per output
//            tile (no float atomics): the last of its chunks' blocks sums the
//            partials in chunk order into t, so phase B reads t once.  A
//            bank's partials are summed by phase B, once: each phase-B block
//            is one expert's row tile and makes all of its columns.
//   phase B  expand through the output cores: every block stages its rows
//            of t (a bank's: sums its expert's partials) in shared memory,
//            then
//     expand1_kernel  one output core (depth 2, or split 2's last core);
//            expand1_wide_kernel for a bank's tiles of at most 4 rows, one
//            16-byte load a row of g;
//     expand2_kernel  two output cores (split 1): the grid splits n2 and n3
//            (a bank's block loops over them), and each tile forms t2 = t .
//            g1[:, i2, :] with the r1 sum spread over its 8 warps, so a 16 x
//            64 output has 128 blocks.
//            The scale product (lead scale x every core's scale) is formed
//            here on the chip and multiplies y once; y is written in x's type.
//
// x is float32 or bf16, widened in registers; accumulation is float32
// throughout (int8 products in s32).  Every sum runs in a fixed order, so
// repeat calls are bit-identical.  At decode batch sizes every phase is
// bound by the bytes of the cores it reads; see PERF.md for times beside
// that bound.
//
// Rows of a core that stream through shared memory start anywhere: a row
// [src, src + n) is copied as the 16-byte-aligned chunks that cover it, so
// its first element sits at byte (src % 16) of its shared row; bytes past the
// row end are zero-filled by cp.async's source size, never read.  A chunk
// never crosses a 16-byte boundary of the tensor's memory, so it never
// touches another page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemCap = 200 * 1024;   // dynamic shared memory a launch may ask

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; the bytes past `bytes` are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk `ch` of the copy of the row [src, src + nbytes) (see the header);
// nbytes = 0 zero-fills the chunk (src is then any mapped address).
__device__ __forceinline__ void row_chunk(char* dst, const void* src, int nbytes, int ch) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t base = a & ~(uintptr_t)15;
  const uintptr_t c = base + 16 * (uintptr_t)ch;
  const long long left = nbytes > 0 ? (long long)(a + nbytes) - (long long)c : 0;
  const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
  cp_async16(dst + 16 * ch, reinterpret_cast<const void*>(bytes ? c : base), bytes);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The scale product of one expert's chain: lead scale (per expert) x the
// first core's x the tail cores'; a null pointer is 1.
struct Scales {
  const float* ls;
  const float* s0;
  const float* s1;
  const float* s2;
  __device__ float of(int e) const {
    float v = ls ? ls[e] : 1.f;
    if (s0) v *= *s0;
    if (s1) v *= *s1;
    if (s2) v *= *s2;
    return v;
  }
};

// Write a block's part of the rank vector: rows row0 + b0 + bstep * u
// (u < N, below nrow), column c0 + col of an R-wide vector.  With one chunk
// straight into t; otherwise into this chunk's partial, and the last block
// of the output tile (an integer ticket; `counter` is left at 0 again) sums
// the nchunk partials in chunk order into t.
template <int N>
__device__ __forceinline__ void finish_tile(const float (&out)[N], int b0, int bstep, int col,
                            int ncol, int nrow, float* __restrict__ part,
                            float* __restrict__ t, int* counter, size_t e,
                            int B, int R, int row0, int c0, int chunk,
                            int nchunk) {
  __shared__ int last;
  if (nchunk == 1) {
    if (col < ncol)
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int b = b0 + bstep * u;
        if (b < nrow) t[(e * B + row0 + b) * R + c0 + col] = out[u];
      }
    return;
  }
  if (col < ncol)
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int b = b0 + bstep * u;
      if (b < nrow)
        part[((e * nchunk + chunk) * B + row0 + b) * R + c0 + col] = out[u];
    }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(counter, 1);
    last = ticket == nchunk - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (col < ncol)
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int b = b0 + bstep * u;
      if (b >= nrow) continue;
      const float* p = part + (e * nchunk * B + row0 + b) * R + c0 + col;
      float v = 0.f;
#pragma unroll 8
      for (int c = 0; c < nchunk; ++c) v += __ldcg(p + (size_t)c * B * R);
      t[(e * B + row0 + b) * R + c0 + col] = v;
    }
}

// ---------------------------------------------------------------------------
// Phase A, split 1, one chain: absorb_in_kernel
// ---------------------------------------------------------------------------

constexpr int kACols = 32;                       // rank columns per block
constexpr int kAGroups = kThreads / kACols;      // 8
constexpr int kAKSub = 16;                       // k rows per absorbed tile
constexpr int kASg = 8;                          // lead entries per stage
constexpr int kARowsMax = 64;                    // token rows per block
constexpr int kAAcc = kAKSub / kAGroups;         // 2 absorbed values a thread
constexpr int kAOut = kARowsMax / kAGroups;      // 8 rank values a thread
constexpr int kAXPer = kARowsMax * kAKSub / kThreads;   // 4 x values a thread
constexpr int kALead = 1024;                     // lead entries kept in shared

template <typename T0, typename X>
struct AbsorbCfg {
  static constexpr int kRow = kACols * (int)sizeof(T0) + 16;   // bytes
  static constexpr int kChunks = kRow / 16;
  static constexpr int kStages = sizeof(T0) == 4 ? 3 : 6;
  static constexpr int kGBytes = kASg * kAKSub * kRow;         // g0 slab
  // the sub-tile's x rows ride with its last s-group's stage
  static constexpr int kXRow = kAKSub * (int)sizeof(X) + 16;
  static constexpr int kXChunks = kXRow / 16;
  static constexpr int kStage = kGBytes + kARowsMax * kXRow;
  static constexpr int kSmem = kStages * kStage;   // the ring, dynamic
};

// part/t[e, b, r] = sum_{k in chunk} x[e, b, k] sum_s lead[e, s] g0[e, s, k, r]
// grid (ceil(r1 / 32), nchunk, E * ceil(B / rows)): the blocks of one chunk
// are neighbours in launch order, so together they read whole rows of g0.
// Stage i of the ring is the slab (s-group sg, k sub-tile sub): 8 s x 16 k
// rows of 32 columns.
template <typename T0, typename X>
__global__ void __launch_bounds__(kThreads, 2) absorb_in_kernel(
    const X* __restrict__ x, const T0* __restrict__ lead, long long lead_es,
    const T0* __restrict__ g0, long long g0_es, float* __restrict__ part,
    float* __restrict__ t, int* __restrict__ counters, int B, int rs, int n1,
    int r1, int kchunk, int rows) {
  using Cfg = AbsorbCfg<T0, X>;
  extern __shared__ __align__(16) char aring[];
  char* ring = aring;
  __shared__ float as[kAKSub][kACols];
  __shared__ __align__(16) float xs[kARowsMax][kAKSub];
  __shared__ float lsm[kALead];
  const int tid = threadIdx.x, col = tid % kACols, grp = tid / kACols;
  const int c0 = blockIdx.x * kACols, ncol = min(kACols, r1 - c0);
  const int rt = (B + rows - 1) / rows;
  const size_t e = blockIdx.z / rt;
  const int row0 = (blockIdx.z % rt) * rows, nrow = min(rows, B - row0);
  const int k0 = blockIdx.y * kchunk, k1 = min(n1, k0 + kchunk);
  const X* xb = x + (e * B + row0) * n1;
  const T0* lp = lead ? lead + e * lead_es : nullptr;
  const T0* gb = g0 + e * g0_es;
  const size_t slab = (size_t)n1 * r1;
  const int nsub = (k1 - k0 + kAKSub - 1) / kAKSub;
  const int nsg = (rs + kASg - 1) / kASg;
  const int ntile = nsub * nsg;
  // byte offset of row (s, k) in its shared row: its address mod 16
  const unsigned g_lo = (unsigned)reinterpret_cast<uintptr_t>(gb + c0);
  const unsigned slab_lo = (unsigned)(slab * sizeof(T0));
  const unsigned r1_lo = (unsigned)((size_t)r1 * sizeof(T0));

  // the lead row, widened once (entries past kALead are read from memory)
  for (int s = tid; s < min(rs, kALead); s += kThreads)
    lsm[s] = lp ? widen(lp[s]) : 1.f;
  auto issue = [&](int i) {
    if (i < ntile) {
      const int sub = i / nsg, sg = i % nsg;
      char* st = ring + (i % Cfg::kStages) * Cfg::kStage;
      for (int j = tid; j < kASg * kAKSub * Cfg::kChunks; j += kThreads) {
        const int row = j / Cfg::kChunks, ch = j % Cfg::kChunks;
        const int s = sg * kASg + row / kAKSub;
        const int k = k0 + sub * kAKSub + row % kAKSub;
        const bool ok = s < rs && k < k1;
        const T0* src = ok ? gb + s * slab + (size_t)k * r1 + c0 : gb;
        row_chunk(st + row * Cfg::kRow, src, ok ? ncol * (int)sizeof(T0) : 0, ch);
      }
      if (sg == nsg - 1) {   // x[b, kb : kb + 16] of the sub-tile's rows
        const int kb = k0 + sub * kAKSub, kl = min(kAKSub, k1 - kb);
        char* xst = st + Cfg::kGBytes;
        for (int j = tid; j < kARowsMax * Cfg::kXChunks; j += kThreads) {
          const int b = j / Cfg::kXChunks, ch = j % Cfg::kXChunks;
          const bool ok = b < nrow;
          const X* src = ok ? xb + (size_t)b * n1 + kb : xb;
          row_chunk(xst + b * Cfg::kXRow, src, ok ? kl * (int)sizeof(X) : 0, ch);
        }
      }
    }
    cp_commit();
  };

  float acc[kAAcc], out[kAOut];
#pragma unroll
  for (int u = 0; u < kAAcc; ++u) acc[u] = 0.f;
#pragma unroll
  for (int v = 0; v < kAOut; ++v) out[v] = 0.f;
#pragma unroll
  for (int i = 0; i < Cfg::kStages - 1; ++i) issue(i);
  for (int i = 0; i < ntile; ++i) {
    const int sub = i / nsg, sg = i % nsg;
    const int kb = k0 + sub * kAKSub;
    cp_wait<Cfg::kStages - 2>();
    __syncthreads();
    issue(i + Cfg::kStages - 1);
    const char* st = ring + (i % Cfg::kStages) * Cfg::kStage;
#pragma unroll
    for (int q = 0; q < kASg; ++q) {
      const int s = sg * kASg + q;
      const float lv = s < rs ? (s < kALead ? lsm[s] : widen(lp[s])) : 0.f;
#pragma unroll
      for (int u = 0; u < kAAcc; ++u) {
        const int kk = grp + u * kAGroups;
        const unsigned off =
            (g_lo + (unsigned)s * slab_lo + (unsigned)(kb + kk) * r1_lo) & 15u;
        const T0 gv = *reinterpret_cast<const T0*>(
            st + (q * kAKSub + kk) * Cfg::kRow + off + col * sizeof(T0));
        acc[u] = fmaf(lv, widen(gv), acc[u]);
      }
    }
    if (sg == nsg - 1) {   // the sub-tile is absorbed: contract it with x
#pragma unroll
      for (int u = 0; u < kAAcc; ++u) {
        as[grp + u * kAGroups][col] = acc[u];
        acc[u] = 0.f;
      }
      const char* xst = st + Cfg::kGBytes;
      const unsigned x_lo = (unsigned)reinterpret_cast<uintptr_t>(xb + kb);
      const unsigned n1_lo = (unsigned)((size_t)n1 * sizeof(X));
#pragma unroll
      for (int m = 0; m < kAXPer; ++m) {   // widened, zeros past the tile
        const int j = tid + m * kThreads, b = j / kAKSub, kk = j % kAKSub;
        float v = 0.f;
        if (b < nrow && kb + kk < k1)
          v = widen(*reinterpret_cast<const X*>(
              xst + b * Cfg::kXRow + ((x_lo + (unsigned)b * n1_lo) & 15u) +
              kk * sizeof(X)));
        xs[b][kk] = v;
      }
      __syncthreads();
      // a warp's rows are one row group: x reads are broadcasts, 4 a load
#pragma unroll
      for (int k4 = 0; k4 < kAKSub; k4 += 4) {
        const float a0 = as[k4][col], a1 = as[k4 + 1][col];
        const float a2 = as[k4 + 2][col], a3 = as[k4 + 3][col];
#pragma unroll
        for (int v = 0; v < kAOut; ++v) {
          const int b = grp + v * kAGroups;
          if (b < nrow) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[b][k4]);
            float sum = out[v];
            sum = fmaf(xv.x, a0, sum);
            sum = fmaf(xv.y, a1, sum);
            sum = fmaf(xv.z, a2, sum);
            out[v] = fmaf(xv.w, a3, sum);
          }
        }
      }
    }
  }
  cp_wait<0>();
  finish_tile(out, grp, kAGroups, col, ncol, nrow, part, t,
              counters + blockIdx.x + gridDim.x * blockIdx.z, e, B, r1, row0,
              c0, blockIdx.y, gridDim.y);
}

// ---------------------------------------------------------------------------
// Phase A, split 1, an expert bank: bank_kernel (tensor cores for bf16/int8)
// ---------------------------------------------------------------------------

constexpr int kBankM = 64;                      // experts (lead rows) a block
constexpr int kBankNMax = 256;                  // (k, r) columns a block
constexpr int kBankStages = 4;
constexpr int kBankWarps = kThreads / 32;
constexpr int kBankNT = kBankNMax / 8 / kBankWarps;   // n8 tiles a warp: 4
constexpr int kBankDRow = kBankNMax + 4;              // floats a result row

template <typename T0>
struct BankCfg {
  static constexpr int kS = 64 / (int)sizeof(T0);   // lead entries a stage
  static constexpr int kLRow = 64 + 16;             // lead row bytes
  static constexpr int kLChunks = kLRow / 16;
  static constexpr int kBRow = kBankNMax * (int)sizeof(T0) + 16;  // slab row
  static constexpr int kLBytes = kBankM * kLRow;
  static constexpr int kStage = kLBytes + kS * kBRow;
  static constexpr int kRing = kBankStages * kStage;
  static constexpr int kD = kBankM * kBankDRow * 4;
  static constexpr int kSmem = kRing > kD ? kRing : kD;
};

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t ld_pair16(const char* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 3) == 0)
    return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)*reinterpret_cast<const uint16_t*>(p) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(p + 2) << 16);
}

__device__ __forceinline__ uint32_t ld_quad8(const char* p) {
  const uint8_t* q = reinterpret_cast<const uint8_t*>(p);
  return (uint32_t)q[0] | ((uint32_t)q[1] << 8) | ((uint32_t)q[2] << 16) |
         ((uint32_t)q[3] << 24);
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

// c += a (16 x 32, row-major) * b (32 x 8, column-major), int8 -> s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T0> struct BankAcc { using type = float; };
template <> struct BankAcc<int8_t> { using type = int; };

// part[e, chunk, c, r] = sum over the block's columns j = k r1 + r of
// x[e, c, k] D[e, j], D = lead (E x r_s) . g0 (r_s x n1 r1): a block owns the
// flat columns [j0, j0 + nbmax) of g0's (k, r) plane (whole k rows or not;
// the partials of all blocks sum to the chain's rank vector).
// grid (nchunk, ceil(E / 64)).  Warp w owns the n8 tiles 2w, 2w + 1, 2w + 16
// and 2w + 17 of the block's columns for all 64 lead rows, in the mma
// accumulator layout (lane g = lane / 4, q = lane % 4: rows g and g + 8,
// columns 2q and 2q + 1 of each 16 x 8 tile); float32 runs the same layout
// on FFMA.  Where the lead rows, or g0's rows, start on 16 bytes in shared
// memory (r_s, or n1 r1, a multiple of 16 bytes), the A fragments come from
// ldmatrix, and bf16 B fragments from ldmatrix.trans.
template <typename T0, typename X>
__global__ void __launch_bounds__(kThreads, 2) bank_kernel(
    const X* __restrict__ x, const T0* __restrict__ lead,
    const T0* __restrict__ g0, float* __restrict__ part, int E, int C, int rs,
    int n1, int r1, int nbmax) {
  using Cfg = BankCfg<T0>;
  using Acc = typename BankAcc<T0>::type;
  constexpr int isz = sizeof(T0);
  extern __shared__ __align__(16) char bsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int chunk = blockIdx.x, nchunk = gridDim.x;
  const int eg0 = blockIdx.y * kBankM;
  const size_t plane = (size_t)n1 * r1;
  const size_t j0 = (size_t)chunk * nbmax;
  const int nb = (int)min((size_t)nbmax, plane - j0);   // columns of this block
  const int ntc = (nb + 7) / 8;                        // n8 tiles of this block
  const int nst = (rs + Cfg::kS - 1) / Cfg::kS;
  const unsigned lead_lo = (unsigned)reinterpret_cast<uintptr_t>(lead);
  const unsigned b_lo = (unsigned)reinterpret_cast<uintptr_t>(g0 + j0);
  const unsigned slab_lo = (unsigned)(plane * isz);
  const int nchB = (nb * isz + 15) / 16 + 1;
  // lead rows on 16-byte boundaries in every stage (kS entries are 64
  // bytes): the A fragments come from ldmatrix; g0's rows likewise (j0 is a
  // multiple of 8 columns): bf16 B fragments from ldmatrix.trans
  const bool lead_aligned =
      (reinterpret_cast<uintptr_t>(lead) & 15) == 0 && (rs * isz) % 16 == 0;
  const bool b_aligned =
      (reinterpret_cast<uintptr_t>(g0) & 15) == 0 && (plane * isz) % 16 == 0;
  // this thread's copies of a stage, the same (row, chunk) every stage:
  // row | chunk << 16, or -1
  constexpr int kLSlots = (kBankM * Cfg::kLChunks + kThreads - 1) / kThreads;
  constexpr int kBSlots =
      (Cfg::kS * (kBankNMax * isz / 16 + 1) + kThreads - 1) / kThreads;
  int lslot[kLSlots], bslot[kBSlots];
#pragma unroll
  for (int j = 0; j < kLSlots; ++j) {
    const int idx = tid + j * kThreads;
    lslot[j] = idx < kBankM * Cfg::kLChunks
                   ? (idx / Cfg::kLChunks) | ((idx % Cfg::kLChunks) << 16) : -1;
  }
#pragma unroll
  for (int j = 0; j < kBSlots; ++j) {
    const int idx = tid + j * kThreads;
    bslot[j] = idx < Cfg::kS * nchB ? (idx / nchB) | ((idx % nchB) << 16) : -1;
  }

  auto issue = [&](int i) {
    if (i < nst) {
      const int s0 = i * Cfg::kS;
      char* st = bsm + (i % kBankStages) * Cfg::kStage;
      const int lbytes = min(Cfg::kS, rs - s0) * isz;
#pragma unroll
      for (int j = 0; j < kLSlots; ++j) {
        if (lslot[j] < 0) continue;
        const int row = lslot[j] & 0xffff, ch = lslot[j] >> 16;
        const int e = eg0 + row;
        const bool ok = e < E;
        const T0* src = ok ? lead + (size_t)e * rs + s0 : lead;
        row_chunk(st + row * Cfg::kLRow, src, ok ? lbytes : 0, ch);
      }
      char* bs = st + Cfg::kLBytes;
#pragma unroll
      for (int j = 0; j < kBSlots; ++j) {
        if (bslot[j] < 0) continue;
        const int sl = bslot[j] & 0xffff, ch = bslot[j] >> 16;
        const int s = s0 + sl;
        const bool ok = s < rs;
        const T0* src = ok ? g0 + (size_t)s * plane + j0 : g0;
        row_chunk(bs + sl * Cfg::kBRow, src, ok ? nb * isz : 0, ch);
      }
    }
    cp_commit();
  };

  // the warp's n8 tiles: 2w, 2w + 1, 2w + 16, 2w + 17
  auto tile = [&](int nl) { return 2 * warp + (nl & 1) + 16 * (nl >> 1); };
  Acc acc[4][kBankNT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nl = 0; nl < kBankNT; ++nl)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nl][v] = 0;
  // lead rows of this lane: mt * 16 + g + 8 h
  unsigned lrow_lo[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lrow_lo[mt][h] = lead_lo + (unsigned)((eg0 + mt * 16 + g + 8 * h) * rs) * isz;

#pragma unroll
  for (int i = 0; i < kBankStages - 1; ++i) issue(i);
  for (int i = 0; i < nst; ++i) {
    cp_wait<kBankStages - 2>();
    __syncthreads();
    issue(i + kBankStages - 1);
    const int s0 = i * Cfg::kS;
    const char* st = bsm + (i % kBankStages) * Cfg::kStage;
    const char* bs = st + Cfg::kLBytes;
    const char* lrow[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lrow[mt][h] = st + (mt * 16 + g + 8 * h) * Cfg::kLRow +
                      ((lrow_lo[mt][h] + (unsigned)s0 * isz) & 15u);
    auto brow = [&](int sl) {
      return bs + sl * Cfg::kBRow + ((b_lo + (unsigned)(s0 + sl) * slab_lo) & 15u);
    };
    if constexpr (isz == 2) {
#pragma unroll
      for (int kk = 0; kk < Cfg::kS; kk += 16) {
        uint32_t a[4][4];
        if (lead_aligned) {   // every lead row starts on 16 bytes: ldmatrix
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldsm_x4(st + (mt * 16 + (lane & 15)) * Cfg::kLRow +
                        (kk + (lane >> 4) * 8) * 2, a[mt]);
        } else {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            a[mt][0] = ld_pair16(lrow[mt][0] + (kk + 2 * q) * 2);
            a[mt][1] = ld_pair16(lrow[mt][1] + (kk + 2 * q) * 2);
            a[mt][2] = ld_pair16(lrow[mt][0] + (kk + 2 * q + 8) * 2);
            a[mt][3] = ld_pair16(lrow[mt][1] + (kk + 2 * q + 8) * 2);
          }
        }
        uint32_t b[kBankNT][2];
        if (b_aligned) {   // two n8 tiles a ldmatrix.trans (k rows kk..kk+15)
#pragma unroll
          for (int p = 0; p < kBankNT / 2; ++p) {
            uint32_t r[4];
            ldsm_x4_trans(bs + (kk + (lane & 15)) * Cfg::kBRow +
                              (tile(2 * p) * 8 + (lane >> 4) * 8) * 2, r);
            b[2 * p][0] = r[0];
            b[2 * p][1] = r[1];
            b[2 * p + 1][0] = r[2];
            b[2 * p + 1][1] = r[3];
          }
        } else {
          const char* r0 = brow(kk + 2 * q);
          const char* r1p = brow(kk + 2 * q + 1);
          const char* r8 = brow(kk + 2 * q + 8);
          const char* r9 = brow(kk + 2 * q + 9);
#pragma unroll
          for (int nl = 0; nl < kBankNT; ++nl) {
            const int n = (tile(nl) * 8 + g) * 2;
            b[nl][0] = (uint32_t)*reinterpret_cast<const uint16_t*>(r0 + n) |
                       ((uint32_t)*reinterpret_cast<const uint16_t*>(r1p + n) << 16);
            b[nl][1] = (uint32_t)*reinterpret_cast<const uint16_t*>(r8 + n) |
                       ((uint32_t)*reinterpret_cast<const uint16_t*>(r9 + n) << 16);
          }
        }
#pragma unroll
        for (int nl = 0; nl < kBankNT; ++nl) {
          if (tile(nl) < ntc) {
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              mma_bf16(acc[mt][nl], a[mt], b[nl][0], b[nl][1]);
          }
        }
      }
    } else if constexpr (isz == 1) {
#pragma unroll
      for (int kk = 0; kk < Cfg::kS; kk += 32) {
        uint32_t a[4][4];
        if (lead_aligned) {   // the int8 A fragment is the b16 one: ldmatrix
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldsm_x4(st + (mt * 16 + (lane & 15)) * Cfg::kLRow + kk +
                        (lane >> 4) * 16, a[mt]);
        } else {
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            a[mt][0] = ld_quad8(lrow[mt][0] + kk + 4 * q);
            a[mt][1] = ld_quad8(lrow[mt][1] + kk + 4 * q);
            a[mt][2] = ld_quad8(lrow[mt][0] + kk + 16 + 4 * q);
            a[mt][3] = ld_quad8(lrow[mt][1] + kk + 16 + 4 * q);
          }
        }
        const char* rb[8];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          rb[v] = brow(kk + 4 * q + v);
          rb[4 + v] = brow(kk + 16 + 4 * q + v);
        }
#pragma unroll
        for (int nl = 0; nl < kBankNT; ++nl) {
          if (tile(nl) < ntc) {
            const int n = tile(nl) * 8 + g;
            const uint32_t b0 = (uint32_t)(uint8_t)rb[0][n] | ((uint32_t)(uint8_t)rb[1][n] << 8) |
                                ((uint32_t)(uint8_t)rb[2][n] << 16) | ((uint32_t)(uint8_t)rb[3][n] << 24);
            const uint32_t b1 = (uint32_t)(uint8_t)rb[4][n] | ((uint32_t)(uint8_t)rb[5][n] << 8) |
                                ((uint32_t)(uint8_t)rb[6][n] << 16) | ((uint32_t)(uint8_t)rb[7][n] << 24);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt][nl], a[mt], b0, b1);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < Cfg::kS; ++kk) {
        float alo[4], ahi[4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          alo[mt] = *reinterpret_cast<const float*>(lrow[mt][0] + kk * 4);
          ahi[mt] = *reinterpret_cast<const float*>(lrow[mt][1] + kk * 4);
        }
        const char* rk = brow(kk);
#pragma unroll
        for (int nl = 0; nl < kBankNT; ++nl) {
          if (tile(nl) < ntc) {
            const float b0 = *reinterpret_cast<const float*>(rk + (tile(nl) * 8 + 2 * q) * 4);
            const float b1 = *reinterpret_cast<const float*>(rk + (tile(nl) * 8 + 2 * q + 1) * 4);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              acc[mt][nl][0] = fmaf(alo[mt], b0, acc[mt][nl][0]);
              acc[mt][nl][1] = fmaf(alo[mt], b1, acc[mt][nl][1]);
              acc[mt][nl][2] = fmaf(ahi[mt], b0, acc[mt][nl][2]);
              acc[mt][nl][3] = fmaf(ahi[mt], b1, acc[mt][nl][3]);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
  // the absorbed tile D (64 x nb) to shared memory, over the ring
  float* D = reinterpret_cast<float*>(bsm);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nl = 0; nl < kBankNT; ++nl) {
      if (tile(nl) < ntc) {
        const int c = tile(nl) * 8 + 2 * q;
        float* d0 = D + (mt * 16 + g) * kBankDRow + c;
        float* d8 = d0 + 8 * kBankDRow;
        d0[0] = (float)acc[mt][nl][0];
        d0[1] = (float)acc[mt][nl][1];
        d8[0] = (float)acc[mt][nl][2];
        d8[1] = (float)acc[mt][nl][3];
      }
    }
  __syncthreads();
  // column j of the block is (k, r) = divmod(j0 + j, r1)
  const int ne = min(kBankM, E - eg0);
  const int per_e = C * r1;
  const int jr = (int)(j0 % r1);
  const size_t kb = j0 / r1;
  for (int idx = tid; idx < ne * per_e; idx += kThreads) {
    const int el = idx / per_e, rem = idx % per_e, c = rem / r1, r = rem % r1;
    const size_t eg = (size_t)eg0 + el;
    const int jst = (r - jr + r1) % r1;          // first column of rank r
    const X* xr = x + (eg * C + c) * n1 + kb + (jr + jst) / r1;
    const float* dr = D + el * kBankDRow;
    float v = 0.f;
    for (int j = jst, k = 0; j < nb; j += r1, ++k)
      v = fmaf(widen(xr[k]), dr[j], v);
    part[((eg * nchunk + chunk) * C + c) * r1 + r] = v;
  }
}

// ---------------------------------------------------------------------------
// Phase A, split 2: contract2_kernel
// ---------------------------------------------------------------------------

constexpr int kCSTile = 64;    // r2 columns per block
constexpr int kCRowsMax = 32;  // token rows per block
constexpr int kCRowGroups = kThreads / kCSTile;        // 4
constexpr int kCRowsPer = kCRowsMax / kCRowGroups;     // 8
constexpr int kCPro = 8192;                            // first-core elements a pass
constexpr int kCProPer = kCPro / kThreads;             // 32 a thread
constexpr int kCStages = 3;

inline size_t contract2_smem(int n1, int r1, int rc, int isz) {
  const size_t as = ((size_t)n1 * r1 * 4 + 15) / 16 * 16;
  const size_t ring = (size_t)kCStages * (kCPro * isz + 16);
  const size_t work =
      ((size_t)kCRowsMax * rc + (size_t)rc * kCSTile + (size_t)kCRowsMax * n1) * 4;
  return as + (ring > work ? ring : work);
}

// x (E, B, n1 * n2) as (E, B, n1, n2).  Prologue: W's first core
// A[a, r] = sum_s lead[s] g0[s, a, r] into shared memory, the stored slabs
// g0[s] (n1 r1 contiguous elements, 8,192 a pass) streaming through a
// cp.async ring, 32 elements a thread summed in registers.  Then
// part/t[e, b, s] = sum_{i2 in chunk} sum_r (sum_a x[b, a, i2] A[a, r]) g1[r, i2, s],
// rc columns of r1 at a time (g1's rows for them loaded together).
// grid (nchunk, ceil(r2 / 64), E * ceil(B / rows)).
template <typename T0, typename T, typename X>
__global__ void __launch_bounds__(kThreads, 2) contract2_kernel(
    const X* __restrict__ x, const T0* __restrict__ lead, long long lead_es,
    const T0* __restrict__ g0, long long g0_es, const T* __restrict__ g1,
    float* __restrict__ part, float* __restrict__ t, int* __restrict__ counters,
    int B, int rs, int n1, int n2, int r1, int r2, int ichunk, int rows, int rc) {
  constexpr int kStage = kCPro * (int)sizeof(T0) + 16;
  extern __shared__ __align__(16) float csm[];
  const size_t nA = (size_t)n1 * r1;
  float* as = csm;                                         // [n1][r1]
  char* work = reinterpret_cast<char*>(csm) + (nA * 4 + 15) / 16 * 16;
  float* ts = reinterpret_cast<float*>(work);              // [32][rc]
  float* gs = ts + kCRowsMax * rc;                         // [rc][64]
  float* xs = gs + rc * kCSTile;                           // [32][n1]
  const int tid = threadIdx.x, sl = tid % kCSTile, rg = tid / kCSTile;
  const int c0 = blockIdx.y * kCSTile;
  const int rt = (B + rows - 1) / rows;
  const size_t e = blockIdx.z / rt;
  const int row0 = (blockIdx.z % rt) * rows, nrow = min(rows, B - row0);
  const size_t n_in = (size_t)n1 * n2;
  const X* xb = x + (e * B + row0) * n_in;
  const T0* lp = lead ? lead + e * lead_es : nullptr;
  const T0* gb = g0 + e * g0_es;

  // prologue: stage i is lead entry s = i % rs of element pass i / rs
  const int nst = (int)((nA + kCPro - 1) / kCPro) * rs;
  auto issue = [&](int i) {
    if (i < nst) {
      const size_t e0 = (size_t)(i / rs) * kCPro;
      const int len = (int)min((size_t)kCPro, nA - e0);
      const T0* src = gb + (size_t)(i % rs) * nA + e0;
      char* st = work + (i % kCStages) * kStage;
      const int nch = (len * (int)sizeof(T0) + 15) / 16 + 1;
      for (int ch = tid; ch < nch; ch += kThreads)
        row_chunk(st, src, len * (int)sizeof(T0), ch);
    }
    cp_commit();
  };
  float pa[kCProPer];
#pragma unroll
  for (int m = 0; m < kCProPer; ++m) pa[m] = 0.f;
#pragma unroll
  for (int i = 0; i < kCStages - 1; ++i) issue(i);
  for (int i = 0; i < nst; ++i) {
    cp_wait<kCStages - 2>();
    __syncthreads();
    issue(i + kCStages - 1);
    const int s = i % rs;
    const size_t e0 = (size_t)(i / rs) * kCPro;
    const char* st = work + (i % kCStages) * kStage +
                     ((unsigned)reinterpret_cast<uintptr_t>(gb + (size_t)s * nA + e0) & 15u);
    const float lv = lp ? widen(lp[s]) : 1.f;
#pragma unroll
    for (int m = 0; m < kCProPer; ++m)
      pa[m] = fmaf(lv, widen(*reinterpret_cast<const T0*>(
                           st + (size_t)(tid + m * kThreads) * sizeof(T0))), pa[m]);
    if (s == rs - 1) {
#pragma unroll
      for (int m = 0; m < kCProPer; ++m) {
        const size_t j = e0 + tid + m * kThreads;
        if (j < nA) as[j] = pa[m];
        pa[m] = 0.f;
      }
    }
  }
  cp_wait<0>();

  const int ib = blockIdx.x * ichunk, ie = min(n2, ib + ichunk);
  float acc[kCRowsPer];
#pragma unroll
  for (int u = 0; u < kCRowsPer; ++u) acc[u] = 0.f;
  for (int r0 = 0; r0 < r1; r0 += rc) {
    const int rl = min(rc, r1 - r0);
    for (int i2 = ib; i2 < ie; ++i2) {
      __syncthreads();   // A complete; ts, gs and xs free
      for (int i = tid; i < nrow * n1; i += kThreads) {   // x[b, :, i2]
        const int b = i / n1, a = i % n1;
        xs[i] = widen(xb[(size_t)b * n_in + (size_t)a * n2 + i2]);
      }
      __syncthreads();
      for (int i = tid; i < kCRowsMax * rc; i += kThreads) {
        const int b = i / rc, j = i % rc;
        float v = 0.f;
        if (b < nrow && j < rl) {
          const float* xr = xs + b * n1;
          for (int a = 0; a < n1; ++a)
            v = fmaf(xr[a], as[(size_t)a * r1 + r0 + j], v);
        }
        ts[i] = v;
      }
      const int rl4 = (rl + 3) & ~3;   // rows past rl are zeros
      for (int i0 = 0; i0 < rl4 * kCSTile; i0 += 8 * kThreads) {
        float gv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads + tid;
          const int j = i / kCSTile, sc = c0 + i % kCSTile;
          gv[u] = (j < rl && sc < r2)
                      ? widen(g1[((size_t)(r0 + j) * n2 + i2) * r2 + sc])
                      : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreads + tid;
          if (i < rl4 * kCSTile) gs[i] = gv[u];
        }
      }
      __syncthreads();
      // a warp's rows are one row group: ts reads are broadcasts, 4 a load
      for (int j = 0; j < rl4; j += 4) {
        const float g0v = gs[j * kCSTile + sl], g1v = gs[(j + 1) * kCSTile + sl];
        const float g2v = gs[(j + 2) * kCSTile + sl], g3v = gs[(j + 3) * kCSTile + sl];
#pragma unroll
        for (int u = 0; u < kCRowsPer; ++u) {
          const float4 tv = *reinterpret_cast<const float4*>(
              &ts[(rg + kCRowGroups * u) * rc + j]);
          float a = fmaf(tv.x, g0v, acc[u]);
          a = fmaf(tv.y, g1v, a);
          a = fmaf(tv.z, g2v, a);
          acc[u] = fmaf(tv.w, g3v, a);
        }
      }
    }
  }
  finish_tile(acc, rg, kCRowGroups, sl, min(kCSTile, r2 - c0), nrow, part, t,
              counters + blockIdx.y + gridDim.y * blockIdx.z, e, B, r2, row0,
              c0, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// Phase B
// ---------------------------------------------------------------------------

constexpr int kRowsB = 16;      // token rows per phase-B block
constexpr int kB2S = 32;        // r2 chunk (expand2)
constexpr int kSumSlots = 2048; // shared floats for the split chunk sum
constexpr int kSumRun = 16;     // chunks one thread sums in a run, at least
constexpr int kNarrow = 4;      // rows of a tile expand1 reads 16 bytes wide

// ts[b * R + r] = sum_{c < nsum} src[((e nsum + c) B + row0 + b) R + r] for
// b < nrow, c ascending: with nsum > 1, an expert bank's chunk partials,
// which phase B reads once (the block is one expert's row tile and covers
// all of its columns).  The chunks are cut into `groups` runs of at least
// kSumRun, summed by separate threads with up to 16 loads in flight, and
// the runs added in order: a fixed partition of the shapes, so the same
// shapes sum the same way.
__device__ void stage_rank(float* ts, float* red, const float* __restrict__ src,
                           int nsum, size_t e, int B, int R, int row0, int nrow) {
  const int P = nrow * R;
  const int groups = max(1, min(kSumSlots / max(P, 1), nsum / kSumRun));
  const size_t cstride = (size_t)B * R;
  const float* base = src + (e * nsum * B + row0) * R;
  if (groups == 1) {
    for (int p = threadIdx.x; p < P; p += kThreads) {
      const float* s = base + (size_t)(p / R) * R + p % R;
      float v = 0.f;
#pragma unroll 8
      for (int c = 0; c < nsum; ++c) v += __ldg(s + c * cstride);
      ts[p] = v;
    }
  } else {
    const int per = (nsum + groups - 1) / groups;
    for (int j = threadIdx.x; j < groups * P; j += kThreads) {
      const int gi = j / P, p = j % P;
      const float* s = base + (size_t)(p / R) * R + p % R;
      const int c1 = min(nsum, gi * per + per);
      float v = 0.f;
#pragma unroll 16
      for (int c = gi * per; c < c1; ++c) v += __ldg(s + c * cstride);
      red[j] = v;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < P; p += kThreads) {
      float v = 0.f;
      for (int gi = 0; gi < groups; ++gi) v += red[gi * P + p];
      ts[p] = v;
    }
  }
  __syncthreads();
}

// 16 bytes of a core row widened: 4 float32, 8 bf16 or 16 int8 values, in
// memory order (little-endian lanes of each 32-bit word).
__device__ __forceinline__ void unpack16(const uint4& v, float (&w)[4], const float*) {
  w[0] = __uint_as_float(v.x);
  w[1] = __uint_as_float(v.y);
  w[2] = __uint_as_float(v.z);
  w[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&w)[8],
                                         const __nv_bfloat16*) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(q[i] << 16);
    w[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& v, float (&w)[16], const int8_t*) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) w[4 * i + k] = (float)((int)(q[i] << (24 - 8 * k)) >> 24);
}

inline size_t expand1_smem(int R) { return ((size_t)kRowsB * R + kSumSlots) * 4; }

// y[e, b, n] = scale_e sum_r t[e, b, r] g[r, n]; grid (ceil(n / (256
// cgroups)), E * ceil(B / 16)).  A thread owns one column and every row of
// the tile; the block's cgroups passes of 256 columns share its rank rows
// (a bank's block makes every pass of n, so its partials are summed once).
// g is read in batches of 8 rows, so 8 loads a thread are in flight.
template <typename T, typename X>
__global__ void __launch_bounds__(kThreads) expand1_kernel(
    const float* __restrict__ src, int nsum, const T* __restrict__ g, Scales sc,
    X* __restrict__ y, int B, int R, int n, int cgroups) {
  extern __shared__ float esm[];
  float* ts = esm;
  float* red = esm + kRowsB * R;
  const int rt = (B + kRowsB - 1) / kRowsB;
  const size_t e = blockIdx.y / rt;
  const int row0 = (blockIdx.y % rt) * kRowsB, nrow = min(kRowsB, B - row0);
  stage_rank(ts, red, src, nsum, e, B, R, row0, nrow);
  const float scale = sc.of((int)e);
  for (int cg = 0; cg < cgroups; ++cg) {
    const int col = (blockIdx.x * cgroups + cg) * kThreads + threadIdx.x;
    if (col >= n) break;
    float acc[kRowsB];
#pragma unroll
    for (int b = 0; b < kRowsB; ++b) acc[b] = 0.f;
    for (int r0 = 0; r0 < R; r0 += 8) {
      float gv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        gv[u] = r0 + u < R ? widen(g[(size_t)(r0 + u) * n + col]) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r0 + u >= R) break;
#pragma unroll
        for (int b = 0; b < kRowsB; ++b)
          acc[b] = fmaf(ts[b * R + r0 + u], gv[u], acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kRowsB; ++b)
      if (b < nrow) store(y + (e * B + row0 + b) * n + col, acc[b] * scale);
  }
}

// A bank's tile of at most kNarrow rows, g's rows on 16 bytes: y[e, b, n] as
// expand1_kernel computes it (each summed over r in ascending order), one
// block an expert covering all n columns so its partials are summed once.
// A thread owns 16 bytes of columns (8 bf16, 16 int8 or 4 float32), read
// as one load a row, 8 rows in flight.  grid (1, E).
template <typename T, typename X>
__global__ void __launch_bounds__(kThreads) expand1_wide_kernel(
    const float* __restrict__ src, int nsum, const T* __restrict__ g, Scales sc,
    X* __restrict__ y, int B, int R, int n) {
  extern __shared__ float esm[];
  float* ts = esm;
  float* red = esm + kRowsB * R;
  const size_t e = blockIdx.y;
  const int nrow = min(B, kNarrow);
  stage_rank(ts, red, src, nsum, e, B, R, 0, nrow);
  const float scale = sc.of((int)e);
  constexpr int kV = 16 / (int)sizeof(T);
  for (int c = (int)threadIdx.x * kV; c < n; c += kThreads * kV) {
    float acc[kNarrow][kV];
#pragma unroll
    for (int b = 0; b < kNarrow; ++b)
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[b][v] = 0.f;
    for (int r0 = 0; r0 < R; r0 += 8) {
      uint4 gq[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        gq[u] = r0 + u < R ? __ldg(reinterpret_cast<const uint4*>(g + (size_t)(r0 + u) * n + c))
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r0 + u >= R) break;
        float w[kV];
        unpack16(gq[u], w, g);
#pragma unroll
        for (int b = 0; b < kNarrow; ++b) {
          if (b >= nrow) break;
          const float tv = ts[b * R + r0 + u];
#pragma unroll
          for (int v = 0; v < kV; ++v) acc[b][v] = fmaf(tv, w[v], acc[b][v]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kNarrow; ++b) {
      if (b >= nrow) break;
#pragma unroll
      for (int v = 0; v < kV; ++v) store(y + (e * B + b) * n + c + v, acc[b][v] * scale);
    }
  }
}

inline size_t expand2_smem(int R1) {
  return ((size_t)kRowsB * R1 + kBankWarps * kRowsB * kB2S + kRowsB * kB2S) * 4;
}
static_assert(kSumSlots <= kBankWarps * kRowsB * kB2S,
              "expand2's stage_rank runs in its warp-sum buffer");

// y[e, b, i2 n3 + j] = scale_e sum_s (sum_r t[e, b, r] g1[r, i2, s]) g2[s, j].
// A tile is one i2 and jt columns of n3, n2 ceil(n3 / jt) tiles a row tile;
// grid (tiles, E * ceil(B / 16)), or with kAllTiles (a bank) (1, ...): the
// block makes every tile of its expert, so its partials are summed once.  t2 =
// t . g1[:, i2, :] 32 columns of r2 at a time: lane = s, warp w sums its
// eighth of r1, and the eight warp sums are added in order.
template <typename T, typename X, bool kAllTiles>
__global__ void __launch_bounds__(kThreads) expand2_kernel(
    const float* __restrict__ src, int nsum, const T* __restrict__ g1,
    const T* __restrict__ g2, Scales sc, X* __restrict__ y, int B, int R1,
    int n2, int R2, int n3, int jt) {
  extern __shared__ float esm[];
  float* ts = esm;                               // [16][R1]
  float* red = ts + kRowsB * R1;                 // [8][16][32]
  float* t2s = red + kBankWarps * kRowsB * kB2S; // [16][32]
  const int jtiles = (n3 + jt - 1) / jt;
  const int rt = (B + kRowsB - 1) / kRowsB;
  const size_t e = blockIdx.y / rt;
  const int row0 = (blockIdx.y % rt) * kRowsB, nrow = min(kRowsB, B - row0);
  stage_rank(ts, red, src, nsum, e, B, R1, row0, nrow);
  const float scale = sc.of((int)e);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rper = (R1 + kBankWarps - 1) / kBankWarps;
  const int rb = warp * rper, re = min(R1, rb + rper);
  const int jj = threadIdx.x % jt, yg = threadIdx.x / jt, ygroups = kThreads / jt;
  constexpr int kYPer = 8;   // rows a thread (jt <= 128)
  for (int tile = blockIdx.x; tile < n2 * jtiles; tile += gridDim.x) {
    const int i2 = tile / jtiles, j0 = (tile % jtiles) * jt;
    float yacc[kYPer];
#pragma unroll
    for (int u = 0; u < kYPer; ++u) yacc[u] = 0.f;
    for (int s0 = 0; s0 < R2; s0 += kB2S) {
      const int s = s0 + lane;
      float a[kRowsB];
#pragma unroll
      for (int b = 0; b < kRowsB; ++b) a[b] = 0.f;
      if (s < R2) {
        for (int r0 = rb; r0 < re; r0 += 8) {
          float gv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            gv[u] = r0 + u < re ? widen(g1[((size_t)(r0 + u) * n2 + i2) * R2 + s]) : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (r0 + u >= re) break;
#pragma unroll
            for (int b = 0; b < kRowsB; ++b)
              a[b] = fmaf(ts[b * R1 + r0 + u], gv[u], a[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kRowsB; ++b) red[(warp * kRowsB + b) * kB2S + lane] = a[b];
      __syncthreads();
      for (int i = threadIdx.x; i < kRowsB * kB2S; i += kThreads) {
        float v = 0.f;
        for (int w = 0; w < kBankWarps; ++w) v += red[w * kRowsB * kB2S + i];
        t2s[i] = v;
      }
      __syncthreads();
      const int sl = min(kB2S, R2 - s0);
      if (j0 + jj < n3) {
        for (int l0 = 0; l0 < sl; l0 += 8) {
          float gv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            gv[u] = l0 + u < sl ? widen(g2[(size_t)(s0 + l0 + u) * n3 + j0 + jj]) : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (l0 + u >= sl) break;
#pragma unroll
            for (int v = 0; v < kYPer; ++v) {
              const int b = yg + ygroups * v;
              if (b < kRowsB) yacc[v] = fmaf(t2s[b * kB2S + l0 + u], gv[u], yacc[v]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (j0 + jj < n3) {
#pragma unroll
      for (int u = 0; u < kYPer; ++u) {
        const int b = yg + ygroups * u;
        if (b < nrow)
          store(y + ((e * B + row0 + b) * n2 + i2) * (size_t)n3 + j0 + jj,
                yacc[u] * scale);
      }
    }
    if constexpr (!kAllTiles) break;   // one tile a block: no loop
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Lift the kernel's dynamic shared-memory limit to kSmemCap, once per
// kernel (its static shared memory counts against the same 48 KB default).
cudaError_t allow_smem(const void* fn) {
  static const void* done[64];
  static int ndone = 0;
  for (int i = 0; i < ndone; ++i)
    if (done[i] == fn) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
  if (err == cudaSuccess && ndone < 64) done[ndone++] = fn;
  return err;
}

enum Route { kRouteAbsorb = 0, kRouteBank = 1, kRouteContract2 = 2 };

// p: x, lead, lead scale, g0, scale0, g1, g2, scale1, scale2, part, t,
//    counters, y (device pointers; null where absent).
// d: route, depth, E, B, r_s, n1, r1, n2, r2, n3, chunk length, nchunk,
//    phase-A rows, phase-B tile (column groups for expand1, jt for expand2),
//    lead expert stride, first-core expert stride, contract2's r1 chunk.
template <typename T0, typename T, typename X>
int run_chain(void* const* p, const int* d, cudaStream_t st) {
  const X* x = static_cast<const X*>(p[0]);
  const T0* lead = static_cast<const T0*>(p[1]);
  const T0* g0 = static_cast<const T0*>(p[3]);
  const T* g1 = static_cast<const T*>(p[5]);
  const T* g2 = static_cast<const T*>(p[6]);
  float* part = static_cast<float*>(p[9]);
  float* t = static_cast<float*>(p[10]);
  int* counters = static_cast<int*>(p[11]);
  X* y = static_cast<X*>(p[12]);
  const Scales sc{static_cast<const float*>(p[2]), static_cast<const float*>(p[4]),
                  static_cast<const float*>(p[7]), static_cast<const float*>(p[8])};
  const int route = d[0], depth = d[1], E = d[2], B = d[3], rs = d[4], n1 = d[5],
            r1 = d[6], n2 = d[7], r2 = d[8], n3 = d[9], chunk = d[10],
            nchunk = d[11], rows_a = d[12], tile_b = d[13];
  const long long lead_es = d[14], g0_es = d[15];
  cudaError_t err;
  const float* src = t;
  int nsum = 1;
  if (route == kRouteBank) {
    const size_t smem = BankCfg<T0>::kSmem;
    err = allow_smem((const void*)bank_kernel<T0, X>);
    if (err != cudaSuccess) return (int)err;
    bank_kernel<T0, X><<<dim3(nchunk, cdiv(E, kBankM)), kThreads, smem, st>>>(
        x, lead, g0, part, E, B, rs, n1, r1, chunk);
    src = part;
    nsum = nchunk;
  } else if (route == kRouteAbsorb) {
    const size_t smem = AbsorbCfg<T0, X>::kSmem;
    err = allow_smem((const void*)absorb_in_kernel<T0, X>);
    if (err != cudaSuccess) return (int)err;
    absorb_in_kernel<T0, X><<<dim3(cdiv(r1, kACols), nchunk, E * cdiv(B, rows_a)),
                              kThreads, smem, st>>>(x, lead, lead_es, g0, g0_es, part,
                                                    t, counters, B, rs, n1, r1, chunk,
                                                    rows_a);
  } else {
    const int rc = d[16];
    const size_t smem = contract2_smem(n1, r1, rc, sizeof(T0));
    err = allow_smem((const void*)contract2_kernel<T0, T, X>);
    if (err != cudaSuccess) return (int)err;
    contract2_kernel<T0, T, X><<<dim3(nchunk, cdiv(r2, kCSTile), E * cdiv(B, rows_a)),
                                 kThreads, smem, st>>>(
        x, lead, lead_es, g0, g0_es, g1, part, t, counters, B, rs, n1, n2, r1, r2,
        chunk, rows_a, rc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles_b = E * cdiv(B, kRowsB);
  if (depth == 3 && route != kRouteContract2) {
    const size_t smem = expand2_smem(r1);
    if (nsum > 1) {   // a bank: one block an expert's row tile (summed once)
      err = allow_smem((const void*)expand2_kernel<T, X, true>);
      if (err != cudaSuccess) return (int)err;
      expand2_kernel<T, X, true><<<dim3(1, tiles_b), kThreads, smem, st>>>(
          src, nsum, g1, g2, sc, y, B, r1, n2, r2, n3, tile_b);
    } else {
      err = allow_smem((const void*)expand2_kernel<T, X, false>);
      if (err != cudaSuccess) return (int)err;
      expand2_kernel<T, X, false><<<dim3(n2 * cdiv(n3, tile_b), tiles_b), kThreads, smem,
                                     st>>>(src, nsum, g1, g2, sc, y, B, r1, n2, r2, n3,
                                           tile_b);
    }
  } else {
    const T* g = depth == 2 ? g1 : g2;
    const int R = depth == 2 ? r1 : r2, n = depth == 2 ? n2 : n3;
    const size_t smem = expand1_smem(R);
    if (nsum > 1 && B <= kNarrow && (n * sizeof(T)) % 16 == 0 &&
        (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      err = allow_smem((const void*)expand1_wide_kernel<T, X>);
      if (err != cudaSuccess) return (int)err;
      expand1_wide_kernel<T, X><<<dim3(1, E), kThreads, smem, st>>>(src, nsum, g, sc, y,
                                                                     B, R, n);
    } else {
      err = allow_smem((const void*)expand1_kernel<T, X>);
      if (err != cudaSuccess) return (int)err;
      expand1_kernel<T, X><<<dim3(cdiv(n, kThreads * tile_b), tiles_b), kThreads, smem, st>>>(
          src, nsum, g, sc, y, B, R, n, tile_b);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry returns a cudaError_t value (0 = launched).  `p` and `d` are
// host arrays laid out as run_chain's; `stream` is a cudaStream_t.  Name:
// tt_chain_<lead and first core>_<tail cores>_<x and y>, each f32, bf16 or
// i8; one chain is E = 1.
#define TT_CHAIN(NAME, T0, T, X)                                             \
  int tt_chain_##NAME(void* const* p, const int* d, void* stream) {          \
    return run_chain<T0, T, X>(p, d, (cudaStream_t)stream);                  \
  }

extern "C" {

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

TT_CHAIN(f32_f32_f32, float, float, float)
TT_CHAIN(f32_f32_bf16, float, float, __nv_bfloat16)
TT_CHAIN(f32_bf16_f32, float, __nv_bfloat16, float)
TT_CHAIN(f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16)
TT_CHAIN(f32_i8_f32, float, int8_t, float)
TT_CHAIN(f32_i8_bf16, float, int8_t, __nv_bfloat16)
TT_CHAIN(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float)
TT_CHAIN(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
TT_CHAIN(i8_i8_f32, int8_t, int8_t, float)
TT_CHAIN(i8_i8_bf16, int8_t, int8_t, __nv_bfloat16)

}  // extern "C"
