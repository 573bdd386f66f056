// Fused 2-layer MLP forward on bf16 tensor cores (3 passes or 1), for
// sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused at
// Precision.HIGH (the Pallas kernel `_kernel3`, with `_split_bf16` and
// `_dot3`).  The chain is kernel A's (csrc/mlp_fused.cu):
//
//   xn = (x - mean) * dev
//   h  = sigmoid(xn @ W1 + b1)        (ICSI fast exp when fast)
//   o  = h @ W2 + b2
//   out = softmax(o) over the n_out columns (fast exp when fast), or o
//
// but each GEMM a @ b is taken on the tensor cores as
//
//   a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi     (PASSES == 3)
//   a_hi @ b_hi                                 (PASSES == 1)
//
// with float32 accumulators, where hi = bf16(a) rounded to nearest even and
// lo = bf16(a - hi), the residual taken in float32 (__float2bfloat16_rn both
// times, as JAX's astype does).  The kernel splits xn and h itself; W1 and
// W2 arrive split and zero-padded (ops/mlp_bf16x3.py::split_weights), W1 as
// [kp, hp] and W2 as [hp, op] (kp, op multiples of 16, hp of 128), so
// padded K lanes, hidden units and output columns add exact zeros.
//
// What bounds it on the H100 (measured on an NVIDIA H100 80GB HBM3 at
// 700.00 W with devtools/mlp_variants.py; PERF.md).  At the CZ shapes the
// three passes are ~4.4M bf16 multiply-adds per row against ~1.2 KB of
// input and output, so the work is the tensor cores' once the [N, n_hid]
// hidden tensor stays on chip (989 TFLOP/s dense bf16).  This kernel
// reaches ~17% of that (1.08 ms for a band net at 65,536 rows; cuBLAS's six
// bare products of the same net take 0.53 ms).  It is held back by what
// mma.sync leaves to each warp: every warp reads its x fragments and its B
// operands from shared memory itself (~3 KB of ldmatrix per 12 products in
// phase 1), and 4 warps a scheduler hide the latency of the ldmatrix ->
// mma chains only in part.  Ablations: the sigmoid and split take ~16% of
// the time, the barriers ~9%, phase 2's products ~27%.
//
// Design (it replaces a wmma kernel that read the weight fragments from
// global memory in every block and passed the hidden chunk through shared
// memory as float32, with three barriers a chunk).
//
// * A block owns a tile of RT rows: 128 rows and 16 warps for large calls,
//   64 rows and 8 warps for calls of fewer rows than one 64-row tile an SM
//   (WIDE_MIN_ROWS), for outputs past 144 columns and where the 128-row tile
//   does not fit.  It normalises and splits its x tile once into shared
//   memory (bf16 hi and lo, [RT][kp + 8], zero past n_inp and the last row).
// * Warps come in pairs (WS = 2) on a stripe of 16 rows.  The block walks
//   the hidden axis in chunks of HC = 64 units, four 16-unit groups; warp
//   `half` of a pair owns groups half and half + 2 of every chunk, for both
//   products: it takes their pre-activations in phase 1 and, in phase 2,
//   their contribution to all n_out columns of its 16 rows.  The pair's
//   two output sums are added (half 0 first) in the epilogue.
// * The weights come through one two-stage ring of slabs in shared memory,
//   filled by the whole block with 16-byte cp.async while the slab before
//   it is multiplied (one barrier a slab): per chunk the slabs
//   [KS1][64] of W1[:, chunk] (KS1 = 2 KS2 rows of k), then the slabs
//   [KS2][op] of W2[chunk, :] (KS2 = 64 or 32 hidden units), hi and lo.
//   Each block reads W1 and W2 from L2 once per RT rows.
// * Products are mma.sync m16n8k16 (bf16 in, float32 sums) by inline PTX,
//   operands by ldmatrix (.trans for the row-major weight slabs), so every
//   thread knows which (row, column) each accumulator holds: an n8 tile's
//   (c0, c1) is row g, columns 2t, 2t + 1 and (c2, c3) row g + 8 (g = lane
//   / 4, t = lane % 4); a 16x16 A fragment is a0 = (g, 2t..), a1 = (g + 8,
//   2t..), a2 = (g, 8 + 2t..), a3 = (g + 8, 8 + 2t..).  So phase 1's two
//   n8 tiles of a 16-unit group take b1, the sigmoid and the hi/lo split in
//   registers and are packed straight into phase 2's A fragments.  The
//   hidden tensor touches neither device nor shared memory.
//
// Fold rule.  The tensor cores' internal adds do not round to nearest, so
// a long chain inside them drifts.  h @ W2 keeps each tensor-core sum to
// one W2 slab's groups of the warp (32 or 16 hidden units) and adds it into
// a float32 total with an ordinary rounded add: without that fold the
// kernel leaves the tolerances (2.1e-5 on probabilities, 1.05e-4 on logits
// at the CZ nets).  xn @ W1 (K <= 480, pre-activations through the
// sigmoid) sums in the tensor cores whole: within 1.04e-5 / 5.1e-5 of the
// plain version either way, and its fold would cost 16 registers a thread
// (~9% of the time).  Within a sum the passes run hi.hi, hi.lo, lo.hi at
// each 16-deep step.
//
// Budget a block (227 KB of dynamic shared memory, 65,536 registers an SM):
// x tile 2 RT (kp + 8) bf16 (the output tile, RT (op + 4) floats, reuses
// it), ring 2 x max(2 KS1 (64 + 8), 2 KS2 (op + 8)) bf16.  The merger (kp
// 288, op 144) at RT = 128 and KS2 = 64 takes 229,376 bytes; every n_inp <=
// MAX_INP = 480 fits the 64-row tile at KS2 = 32 up to n_out <= MAX_OUT =
// 256, the limits kernel A has.  Registers: the output sums are op / 2
// floats a thread (72 at op 144, 128 at op 256), phase 1 holds 16 sums, h
// 16 packed registers.  The 128-row tile (512 threads) and the 64-row tile
// at op <= 144 are held to 128 a thread (ptxas: 52 bytes of spills at 3
// passes, none at 1), the wide tile to 255 (201-204 used, one block an SM).
//
// Wider nets (n_inp > MAX_INP or n_out > MAX_OUT: the 3BT / 1BT mergers,
// 1794 / 2070 -> 1500 -> 138) take a split path (phn_mlp_bf16x3_wide),
// three launches on the stream.  The float32 operands are split once:
// split_rows_kernel writes xn's bf16 hi and lo planes [n_rows, kp] (the
// bytes of xn in float32), and the first product's epilogue writes h =
// sigmoid(xn @ W1 + b1) split, as planes [n_rows, hp], into the caller's
// scratch.  So both products are bf16 GEMMs of planes on wgmma
// (wg_gemm_kernel): two consumer warpgroups on 64-row tiles (a block 128
// rows by 256 columns for the first product, by 144 or 128 for the
// second), m64nNk16 with A and B from shared memory (A K-major, 64-byte
// swizzle; B, the weights as split_weights lays them, MN-major, 128- or
// 32-byte swizzle), the passes in the plain version's order at each
// 16-deep step (hi.hi, hi.lo, lo.hi; hi.hi at 1 pass).  A producer warp
// fills a 4-stage ring of 32-deep slabs with TMA (mbarriers: `full` by
// the copies' bytes, `empty` by the consumer warps), so three slabs are in
// flight while one is multiplied.  The first product sums in the tensor
// cores across all slabs; the second folds each slab's sum into a float32
// total (as the fused kernel's second product) and, where one tile holds
// all n_out columns (op <= 144), takes the row softmax in its epilogue.
//
// What bounds it (PERF.md, devtools/mlp_variants.py --wide on the H100):
// the operations, 2.25 ms of the bf16 peak at the 3BT merger's 128,000
// rows at 3 passes (0.76 ms of bytes at 1), and the slabs from L2: every
// block reads 48 KB of planes a 32-deep slab, 16.4 GB in all at 3 passes.
// Fed by cp.async from 256 threads the first product took 7.8 ms (6.2
// without its products, 3.6 without its loads); TMA keeps three slabs in
// flight from one thread: 5.1 ms, the whole split path 6.4.
//
// A band stack (phn_mlp_bf16x3_bands, the 3BT / 1BT band nets) runs as one
// launch, as in kernel A: a second grid dimension over the nets, each
// block advancing x, mean, dev, the four weight halves, b1, b2 and out by
// its net's stride (Band) first; the band index a template parameter
// (BANDS), as in kernel A, so the single net's instances keep their
// registers.
//
// fexp follows phnrec_tpu/posteriors/fexp.py bit for bit, as in kernel A.
// Build without --use_fast_math.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HC = 64;                 // hidden units per chunk
constexpr int WS = 2;                  // warps on a 16-row stripe
constexpr int GPW = HC / 16 / WS;      // 16-unit groups a warp owns a chunk
constexpr int W1_LD = HC + 8;          // row stride of a W1 slab, bf16
constexpr int MAX_INP = 480;
constexpr int MAX_OUT = 256;
constexpr int NP_NARROW = 9;           // 16-column output pairs: op <= 144
constexpr int NP_WIDE = MAX_OUT / 16;
constexpr int WIDE_MIN_ROWS = 64 * 132 + 1;   // one 64-row tile an SM
constexpr size_t SMEM_MAX = 232448;

constexpr float FEXP_A = 1512775.395195186f;   // 2^20 / ln 2, rounded to f32
constexpr unsigned FEXP_K = 1072693248u - 60801u;

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

// bf16 halves kept of each operand: hi and lo, or hi alone
__host__ __device__ constexpr int halves(int passes) {
  return passes == 3 ? 2 : 1;
}

// bytes of one stage of the ring: a W1 slab [2 ks2][W1_LD] or a W2 slab
// [ks2][op + 8], hi then lo
__host__ __device__ constexpr size_t stage_bytes(int op, int ks2,
                                                 int passes) {
  return round128(cmax((size_t)halves(passes) * 2 * ks2 * W1_LD,
                       (size_t)halves(passes) * ks2 * (op + 8)) *
                  sizeof(bf16));
}

// byte offset of the ring: after the x tile, or the output tile over it
__host__ __device__ constexpr size_t ring_offset(int rt, int kp, int op,
                                                 int passes) {
  return round128(
      cmax((size_t)halves(passes) * rt * (kp + 8) * sizeof(bf16),
           (size_t)rt * (op + 4) * sizeof(float)));
}

__host__ __device__ constexpr size_t smem_bytes(int rt, int kp, int op,
                                                int ks2, int passes) {
  return ring_offset(rt, kp, op, passes) + 2 * stage_bytes(op, ks2, passes);
}
static_assert(smem_bytes(64, MAX_INP, MAX_OUT, 32, 3) <= SMEM_MAX,
              "the widest net does not fit the 64-row tile");

__device__ __forceinline__ float pow2_int(int e) {
  if (e <= -126) return 0.0f;
  if (e >= 128) return __int_as_float(0x7f800000);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float fexp(float y) {
  const int i = __float2int_rz(FEXP_A * y);               // saturates
  const int t = (int)((unsigned)i + FEXP_K);               // wraps
  const int e = (t >> 20) - 1023;
  const float m = (float)(t & 0xFFFFF) * (1.0f / 1048576.0f);
  return pow2_int(e) * (1.0f + m);
}

__device__ __forceinline__ float sigmoid(float a, bool fast) {
  return fast ? 1.0f / (1.0f + fexp(-a)) : 1.0f / (1.0f + expf(-a));
}

__device__ __forceinline__ void split(float v, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

// two bf16 in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8x8 bf16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the passes of one 16-deep step into the sums of two n8 tiles: b holds
// the B fragments of both tiles (ldmatrix.x4.trans of a 16x16 block)
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[2][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[4],
                                           const uint32_t (&bl)[4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    mma(d[n], ah, bh[2 * n], bh[2 * n + 1]);
    if (PASSES == 3) {
      mma(d[n], ah, bl[2 * n], bl[2 * n + 1]);
      mma(d[n], al, bh[2 * n], bh[2 * n + 1]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The ring's slab s (none past the last): chunk s / per_chunk; within it
// n1 W1 slabs [ks1 rows of k][HC units] and then W2 slabs [ks2 units][op],
// hi then lo.  Every row of W1 and W2 starts on a 16-byte boundary (hp and
// op are multiples of 16), so every copy is 16 bytes.
struct Slabs {
  const bf16 *w1h, *w1l, *w2h, *w2l;
  int kp, hp, op, ks1, ks2, n1, per_chunk, n_slabs;
};

template <int NT, int PASSES>
__device__ __forceinline__ void load_slab(unsigned char* stage,
                                          const Slabs& w, int s, int tid) {
  if (s < w.n_slabs) {
    bf16* d = reinterpret_cast<bf16*>(stage);
    const int c = s / w.per_chunk;
    const int t = s - c * w.per_chunk;
    if (t < w.n1) {
      const int k0 = t * w.ks1;
      const int kn = min(w.ks1, w.kp - k0);
      const int per_half = kn * (HC / 8);
      for (int idx = tid; idx < halves(PASSES) * per_half; idx += NT) {
        const int h = idx >= per_half;
        const int e = idx - h * per_half;
        const int r = e / (HC / 8);
        const int q = e % (HC / 8);
        const bf16* src = (h ? w.w1l : w.w1h) + (size_t)(k0 + r) * w.hp +
                          c * HC + 8 * q;
        cp_async16(d + (h * w.ks1 + r) * W1_LD + 8 * q, src);
      }
    } else {
      const int j = c * HC + (t - w.n1) * w.ks2;
      const int cpr = w.op / 8;           // 16-byte pieces a row
      const int per_half = w.ks2 * cpr;
      const int ld = w.op + 8;
      for (int idx = tid; idx < halves(PASSES) * per_half; idx += NT) {
        const int h = idx >= per_half;
        const int e = idx - h * per_half;
        const int r = e / cpr;
        const int q = e - r * cpr;
        const bf16* src =
            (h ? w.w2l : w.w2h) + (size_t)(j + r) * w.op + 8 * q;
        cp_async16(d + (h * w.ks2 + r) * ld + 8 * q, src);
      }
    }
  }
  cp_async_commit();
}

// the elements between one band net's arrays and the next's (all zero for
// a single net): x, mean and dev, the padded W1 and W2 halves, b1, b2, out
struct Band {
  long long x, vec, w1, w2, b1, b2, out;
};

// fast and softmax are uniform over the grid: run-time flags, so that the
// source compiles one kernel per (RT, NP, PASSES) and band index or none
template <int RT, int NP, int PASSES, bool BANDS>
__global__ void __launch_bounds__(RT / 16 * WS * 32,
                                  (RT == 64 && NP == NP_NARROW) ? 2 : 1)
mlp_bf16x3_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ dev, Slabs w,
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  float* __restrict__ out, int n_rows, int n_inp, int n_hid,
                  int n_out, bool fast, bool softmax, const Band bd) {
  if (BANDS) {
    // this block's band net
    x += blockIdx.y * bd.x;
    mean += blockIdx.y * bd.vec;
    dev += blockIdx.y * bd.vec;
    w.w1h += blockIdx.y * bd.w1;
    w.w1l += blockIdx.y * bd.w1;
    w.w2h += blockIdx.y * bd.w2;
    w.w2l += blockIdx.y * bd.w2;
    b1 += blockIdx.y * bd.b1;
    b2 += blockIdx.y * bd.b2;
    out += blockIdx.y * bd.out;
  }
  constexpr int NS = RT / 16;          // stripes of 16 rows
  constexpr int NW = NS * WS;
  constexpr int NT = NW * 32;
  constexpr int MAX_NQ = NP * 16 / 32 + (NP % 2);   // output columns a lane
  const int kp = w.kp, op = w.op;
  const int xld = kp + 8;
  const int npairs = op / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xh = reinterpret_cast<bf16*>(smem);
  bf16* xl = xh + (size_t)RT * xld;              // PASSES == 3 only
  float* os = reinterpret_cast<float*>(smem);   // after the last chunk
  unsigned char* ring = smem + ring_offset(RT, kp, op, PASSES);
  const size_t stage = stage_bytes(op, w.ks2, PASSES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int stripe = warp % NS;
  const int half = warp / NS;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // ldmatrix.x4: this lane's row and column within a 16x16 block
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const long long row0 = (long long)blockIdx.x * RT;
  const int n_chunks = (n_hid + HC - 1) / HC;

  load_slab<NT, PASSES>(ring, w, 0, tid);

  // normalised, split x tile; zero past the last row and past n_inp
  for (int idx = tid; idx < RT * kp; idx += NT) {
    const int r = idx / kp;
    const int k = idx - r * kp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n_rows && k < n_inp) v = (x[row * n_inp + k] - mean[k]) * dev[k];
    const bf16 h = __float2bfloat16_rn(v);
    xh[r * xld + k] = h;
    if (PASSES == 3)
      xl[r * xld + k] = __float2bfloat16_rn(v - __bfloat162float(h));
  }

  float acc[NP][2][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.0f;

  const bf16* xa_h = xh + (16 * stripe + lrow) * xld + lcol;
  const bf16* xa_l = xl + (16 * stripe + lrow) * xld + lcol;
  int s = 0;   // slabs consumed so far: slab s sits in stage s & 1
  for (int c = 0; c < n_chunks; ++c) {
    // phase 1: pre-activations of the warp's groups, 16 rows each
    float pre[GPW][2][4];
#pragma unroll
    for (int i = 0; i < GPW; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pre[i][n][e] = 0.0f;
    for (int t = 0; t < w.n1; ++t, ++s) {
      cp_async_wait_all();
      __syncthreads();
      // slab s has landed and every thread is past slab s-1: the other
      // stage is free for the slab after this one
      load_slab<NT, PASSES>(ring + ((s + 1) & 1) * stage, w, s + 1, tid);
      const bf16* wh = reinterpret_cast<const bf16*>(ring + (s & 1) * stage);
      const bf16* wl = wh + w.ks1 * W1_LD;
      const int k0 = t * w.ks1;
      const int kn = min(w.ks1, kp - k0);
      for (int kk = 0; kk < kn; kk += 16) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, xa_h + k0 + kk);
        if (PASSES == 3) ldsm_x4(al, xa_l + k0 + kk);
#pragma unroll
        for (int i = 0; i < GPW; ++i) {
          const int col = 16 * (half + WS * i) + lcol;
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, wh + (kk + lrow) * W1_LD + col);
          if (PASSES == 3) ldsm_x4_t(bl, wl + (kk + lrow) * W1_LD + col);
          mma_passes<PASSES>(pre[i], ah, al, bh, bl);
        }
      }
    }

    // + b1, sigmoid, split h, packed into phase 2's A fragments: an n8
    // tile's (c0, c1) is row g, (c2, c3) row g + 8, columns 2t and 2t + 1
    uint32_t hh[GPW][4], hl[GPW][4];
#pragma unroll
    for (int i = 0; i < GPW; ++i) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = c * HC + 16 * (half + WS * i) + 8 * n + 2 * t4;
        const float bj0 = j < n_hid ? __ldg(b1 + j) : 0.0f;
        const float bj1 = j + 1 < n_hid ? __ldg(b1 + j + 1) : 0.0f;
        bf16 vh[4], vl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(sigmoid(pre[i][n][e] + ((e & 1) ? bj1 : bj0), fast), vh + e,
                vl + e);
        hh[i][2 * n] = pack(vh[0], vh[1]);
        hh[i][2 * n + 1] = pack(vh[2], vh[3]);
        hl[i][2 * n] = pack(vl[0], vl[1]);
        hl[i][2 * n + 1] = pack(vl[2], vl[3]);
      }
    }

    // phase 2: o[16 rows, op] += h[:, the warp's groups] @ W2[those, :]
    const int n2 = HC / w.ks2;
    for (int v = 0; v < n2; ++v, ++s) {
      cp_async_wait_all();
      __syncthreads();
      load_slab<NT, PASSES>(ring + ((s + 1) & 1) * stage, w, s + 1, tid);
      const bf16* wh = reinterpret_cast<const bf16*>(ring + (s & 1) * stage);
      const int ld = op + 8;
      const bf16* wl = wh + w.ks2 * ld;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p < npairs) {
          float sum[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                             {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int i = 0; i < GPW; ++i) {
            const int r = 16 * (half + WS * i) - v * w.ks2;   // slab row
            if (r >= 0 && r < w.ks2) {
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, wh + (r + lrow) * ld + 16 * p + lcol);
              if (PASSES == 3)
                ldsm_x4_t(bl, wl + (r + lrow) * ld + 16 * p + lcol);
              mma_passes<PASSES>(sum, hh[i], hl[i], bh, bl);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][n][e] += sum[n][e];
        }
      }
    }
  }

  // epilogue: the pair's sums into the output tile (over the x tile, which
  // no warp reads after the last chunk's phase 1), half 0 first
  const int old = op + 4;
#pragma unroll
  for (int hf = 0; hf < WS; ++hf) {
    if (half == hf) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p < npairs) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = 16 * p + 8 * n + 2 * t4;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float2* o = reinterpret_cast<float2*>(
                  os + (16 * stripe + g + 8 * rr) * old + col);
              float2 v = make_float2(acc[p][n][2 * rr], acc[p][n][2 * rr + 1]);
              if (hf > 0) {
                const float2 u = *o;
                v = make_float2(u.x + v.x, u.y + v.y);
              }
              *o = v;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int nq = (n_out + 31) / 32;
  for (int i = 0; i < RT / NW; ++i) {
    const int r = warp * (RT / NW) + i;
    const long long row = row0 + r;
    float vq[MAX_NQ];
#pragma unroll
    for (int q = 0; q < MAX_NQ; ++q) {
      const int o = lane + 32 * q;
      vq[q] = (q < nq && o < n_out) ? os[r * old + o] + __ldg(b2 + o) : 0.0f;
    }
    if (softmax) {
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q)
        if (q < nq && lane + 32 * q < n_out) mx = fmaxf(mx, vq[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) {
        if (q < nq) {
          const float d = vq[q] - mx;
          const float e = fast ? fexp(d) : expf(d);
          vq[q] = lane + 32 * q < n_out ? e : 0.0f;
          sum += vq[q];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) vq[q] = vq[q] / sum;
    }
    if (row < n_rows) {
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) {
        const int o = lane + 32 * q;
        if (q < nq && o < n_out) out[row * n_out + o] = vq[q];
      }
    }
  }
}

// ---- The split path: bf16 products on wgmma ----
//
// The float32 operands are split once into bf16 hi and lo planes in device
// memory: xn by split_rows_kernel, h by the first product's epilogue.  So
// both products are bf16 GEMMs of planes, C = sum over the passes of
// A_p @ B_p, A [M, kp] row-major (K-major), B [kp, np] row-major
// (MN-major), every operand tile copied by TMA straight into the swizzled
// layout wgmma reads.  A block is two consumer warpgroups on 64 rows each
// (BM = 128) by BN columns, and a producer warp.
constexpr int WM = 128;                // rows of a block
constexpr int WK = 32;                 // depth of a slab
constexpr int WS_STAGES = 4;           // stages of the ring
constexpr int A_PLANE = WM * WK * 2;   // bytes of one a plane of a slab

// bytes of one w plane of a slab
__host__ __device__ constexpr int b_plane(int bn) { return WK * bn * 2; }

// bytes of one stage: a hi, a lo, w hi, w lo (each 1,024-byte aligned)
__host__ __device__ constexpr int wg_stage(int bn) {
  return 2 * A_PLANE + 2 * b_plane(bn);
}

// the ring, its 2 x WS_STAGES mbarriers, and room to align the base
__host__ __device__ constexpr size_t wg_smem(int bn) {
  return (size_t)WS_STAGES * wg_stage(bn) + 16 * WS_STAGES + 1024;
}
static_assert(wg_smem(256) <= SMEM_MAX, "the ring does not fit");
static_assert(WM * (144 + 1) * 4 <= WS_STAGES * wg_stage(144),
              "the logits do not fit the ring");

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, int lbo, int sbo,
                                            int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// d[64 x N] (+)= A[64 x 16] B[16 x N] (scale_d 0 overwrites d): A K-major,
// B MN-major (imm-trans-b 1), both in shared memory by descriptor
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n144(float (&d)[72], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b, int scale_d) {
  if constexpr (BN == 128) wgmma_n128(d, a, b, scale_d);
  if constexpr (BN == 144) wgmma_n144(d, a, b, scale_d);
  if constexpr (BN == 256) wgmma_n256(d, a, b, scale_d);
}

// where the split path's products read and write
struct WgArgs {
  const bf16 *ah, *al;   // A planes [M, lda]
  const bf16 *bh, *bl;   // B planes [kp, ldb]
  int lda, ldb, kp;      // kp: the depth, a multiple of 16
  const float* bias;     // [n_valid]
  int n_valid;           // columns of the function (n_hid or n_out)
  bf16 *ch, *cl;         // SPLIT: h planes [M, ldb]
  float* c;              // LOGITS / SOFTMAX: [M, n_valid]
  int M, n_ct;
  bool fast;
};

enum WgEpilogue { SPLIT, LOGITS, SOFTMAX };

// The tensor maps of the four bf16 planes a product reads (kernel
// parameters, __grid_constant__)
struct WgMaps {
  CUtensorMap ah, al, bh, bl;
};

// A stage holds slab t: A, K-major with 64-byte swizzle (row r at r * 64
// bytes, its 16-byte chunk c at c ^ ((r >> 1) & 3)), one TMA box of WK x
// 128 a plane; B, MN-major, in atoms of WA columns x WK rows, one TMA box
// each: at BN a multiple of 64 with 128-byte swizzle (64 columns, row k at
// k * 128 bytes, chunk c at c ^ (k & 7)), else with 32-byte swizzle (16
// columns, row k at k * 32, chunk c at c ^ ((k >> 2) & 1)).  TMA writes
// exactly these layouts and zero-fills past M, kp and the planes' width.
template <int BN>
struct WgAtom {
  static constexpr int COLS = BN % 64 == 0 ? 64 : 16;
  static constexpr int BYTES = COLS * 2 * WK;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// arrives and expects `bytes` of TMA copies in the current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box of `map` at (column c0, row c1) into shared memory, counted on
// the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Two consumer warpgroups, each rows 64 c.. of the block's 128 by BN
// columns, and a producer warp.  The producer's first lane fills the ring
// of WS_STAGES slabs with TMA, each stage's boxes counted on its `full`
// mbarrier; the consumers wait for a stage, issue its products and release
// it on its `empty` mbarrier (a warp's arrival each) once they are done
// (wgmma.wait_group).  So up to WS_STAGES - 1 slabs are in flight while
// one is multiplied, with no block barrier in the loop.  Without FOLD the
// sums run in the tensor cores across all slabs; with FOLD each slab's sum
// (scale_d 0 at its first product) is added into a float32 total with a
// rounded add, as the fused kernel's second product does.
template <int BN, bool FOLD, int PASSES>
__global__ void __launch_bounds__(288, 1)
wg_gemm_kernel(const __grid_constant__ WgMaps maps, const WgArgs p,
               WgEpilogue epi) {
  using Atom = WgAtom<BN>;
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + WS_STAGES * wg_stage(BN);   // mbarriers
  const uint32_t empty = full + 8 * WS_STAGES;
  const int col0 = (int)(blockIdx.x % p.n_ct) * BN;
  const int row0 = (int)(blockIdx.x / p.n_ct) * WM;
  const int n_slabs = (p.kp + WK - 1) / WK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {   // the producer warp
    if (threadIdx.x == 256) {
      constexpr uint32_t bytes = halves(PASSES) * (A_PLANE + b_plane(BN));
      for (int t = 0; t < n_slabs; ++t) {
        const int s = t % WS_STAGES;
        if (t >= WS_STAGES)
          mbar_wait(empty + 8 * s, (t / WS_STAGES - 1) & 1);
        const uint32_t st = ring + s * wg_stage(BN), bar = full + 8 * s;
        mbar_expect(bar, bytes);
        tma_load(st, &maps.ah, t * WK, row0, bar);
        if constexpr (PASSES == 3)
          tma_load(st + A_PLANE, &maps.al, t * WK, row0, bar);
#pragma unroll
        for (int a = 0; a < BN / Atom::COLS; ++a) {
          const uint32_t wb = st + 2 * A_PLANE + a * Atom::BYTES;
          tma_load(wb, &maps.bh, col0 + a * Atom::COLS, t * WK, bar);
          if constexpr (PASSES == 3)
            tma_load(wb + b_plane(BN), &maps.bl, col0 + a * Atom::COLS,
                     t * WK, bar);
        }
      }
    }
    return;
  }
  const int tid = threadIdx.x;   // 0..255 over the consumers
  const int wgi = tid / 128;     // the consumer warpgroup
  const int lane = tid & 31;

  constexpr int NR = BN / 2;   // sums a thread
  float d[NR];
  float tot[FOLD ? NR : 1];
#pragma unroll
  for (int i = 0; i < NR; ++i) d[i] = 0.0f;
  if constexpr (FOLD) {
#pragma unroll
    for (int i = 0; i < NR; ++i) tot[i] = 0.0f;
  }

  for (int t = 0; t < n_slabs; ++t) {
    const int s = t % WS_STAGES;
    mbar_wait(full + 8 * s, (t / WS_STAGES) & 1);
    const uint32_t st = ring + s * wg_stage(BN);
    const uint32_t a0 = st + wgi * (64 * 64);   // the warpgroup's 64 rows
    const uint32_t b0 = st + 2 * A_PLANE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      const uint64_t ah = wg_desc(a0 + 32 * ks, 16, 512, 2);
      const uint64_t al = wg_desc(a0 + A_PLANE + 32 * ks, 16, 512, 2);
      uint64_t bh, bl;
      if constexpr (BN % 64 == 0) {
        bh = wg_desc(b0 + 2048 * ks, Atom::BYTES, 1024, 1);
        bl = wg_desc(b0 + b_plane(BN) + 2048 * ks, Atom::BYTES, 1024, 1);
      } else {
        bh = wg_desc(b0 + 512 * ks, Atom::BYTES, 256, 3);
        bl = wg_desc(b0 + b_plane(BN) + 512 * ks, Atom::BYTES, 256, 3);
      }
      // the passes of a 16-deep step in the plain version's order
      wgmma<BN>(d, ah, bh, FOLD && ks == 0 ? 0 : 1);
      if constexpr (PASSES == 3) {
        wgmma<BN>(d, ah, bl, 1);
        wgmma<BN>(d, al, bh, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (FOLD) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int i = 0; i < NR; ++i) tot[i] += d[i];
    } else {
      // slab t - 1's products are done: its stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (t > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((t - 1) % WS_STAGES));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  auto sum = [&](int i) -> float {
    if constexpr (FOLD) return tot[i];
    return d[i];
  };

  // sum[4 j + e]: row g (e < 2) or g + 8 of the warp's 16, column 8 j + 2 t
  // + (e & 1)
  const int rl = wgi * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);   // + 8
  const int cl = 2 * (lane & 3);
  if (epi == SPLIT) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j + cl;
      if (col >= p.ldb) continue;
      const float b0v = col < p.n_valid ? __ldg(p.bias + col) : 0.0f;
      const float b1v = col + 1 < p.n_valid ? __ldg(p.bias + col + 1) : 0.0f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long row = row0 + rl + 8 * hr;
        if (row >= p.M) continue;
        // h past n_hid is 0 in both halves: the second product's padded K
        bf16 h0 = __float2bfloat16_rn(0.0f), l0 = h0, h1 = h0, l1 = h0;
        if (col < p.n_valid)
          split(sigmoid(sum(4 * j + 2 * hr) + b0v, p.fast), &h0, &l0);
        if (col + 1 < p.n_valid)
          split(sigmoid(sum(4 * j + 2 * hr + 1) + b1v, p.fast), &h1, &l1);
        const size_t o = (size_t)row * p.ldb + col;
        *reinterpret_cast<uint32_t*>(p.ch + o) = pack(h0, h1);
        if constexpr (PASSES == 3)
          *reinterpret_cast<uint32_t*>(p.cl + o) = pack(l0, l1);
      }
    }
    return;
  }
  if (epi == LOGITS) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + 8 * j + cl + (e & 1);
        const long long row = row0 + rl + 8 * (e >> 1);
        if (col < p.n_valid && row < p.M)
          p.c[row * p.n_valid + col] = sum(4 * j + e) + __ldg(p.bias + col);
      }
    }
    return;
  }
  // SOFTMAX: the tile holds every column of its rows; the logits into
  // shared memory, then a warp a row as softmax_rows_kernel
  constexpr int LD = BN + 1;
  // every consumer is past the ring's last slab (the producer has left)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* lg = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + cl + (e & 1);
      lg[(rl + 8 * (e >> 1)) * LD + col] =
          sum(4 * j + e) + (col < p.n_valid ? __ldg(p.bias + col) : 0.0f);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int n = p.n_valid;
  for (int r = tid >> 5; r < WM; r += 8) {
    const long long row = row0 + r;
    if (row >= p.M) break;
    float* v = lg + r * LD;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, v[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = p.fast ? fexp(v[j] - mx) : expf(v[j] - mx);
      v[j] = e;
      s += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    for (int j = lane; j < n; j += 32) p.c[row * n + j] = v[j] / s;
  }
}

// xn = (x - mean) * dev split into hi and lo planes [M, kp], zero past
// n_inp: two columns a thread, packed
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ dev, bf16* __restrict__ xh,
                  bf16* __restrict__ xl, long long M, int n_inp, int kp,
                  bool lo) {
  const long long n_pairs = M * (kp / 2);
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n_pairs;
       i += (long long)gridDim.x * 256) {
    const long long row = i / (kp / 2);
    const int k = 2 * (int)(i % (kp / 2));
    bf16 h[2], l[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = k + e < n_inp ? (x[row * n_inp + k + e] -
                                       __ldg(mean + k + e)) *
                                          __ldg(dev + k + e)
                                    : 0.0f;
      split(v, h + e, l + e);
    }
    reinterpret_cast<uint32_t*>(xh)[i] = pack(h[0], h[1]);
    if (lo) reinterpret_cast<uint32_t*>(xl)[i] = pack(l[0], l[1]);
  }
}

// softmax over each row's n columns, in place: a warp a row
__global__ void __launch_bounds__(256)
softmax_rows_kernel(float* __restrict__ o, int M, int n, bool fast) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float* v = o + row * n;
  float mx = -INFINITY;
  for (int j = lane; j < n; j += 32) mx = fmaxf(mx, v[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float e = fast ? fexp(v[j] - mx) : expf(v[j] - mx);
    v[j] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  for (int j = lane; j < n; j += 32) v[j] = v[j] / sum;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link to libcuda)
PFN_cuTensorMapEncodeTiled encode_tiled() {
  static PFN_cuTensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(f);
  }();
  return fn;
}

// a bf16 plane [rows, cols] row-major, boxes of box_cols x box_rows
cudaError_t plane_map(CUtensorMap* m, const bf16* base, long long rows,
                      int cols, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int BN, bool FOLD, int PASSES>
cudaError_t wg_gemm(WgArgs p, WgEpilogue epi, int n_cols, cudaStream_t s) {
  using Atom = WgAtom<BN>;
  const CUtensorMapSwizzle bsw = BN % 64 == 0 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  WgMaps maps;
  cudaError_t err;
  if ((err = plane_map(&maps.ah, p.ah, p.M, p.lda, WK, WM,
                       CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (err = plane_map(&maps.al, p.al, p.M, p.lda, WK, WM,
                       CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess ||
      (err = plane_map(&maps.bh, p.bh, p.kp, p.ldb, Atom::COLS, WK, bsw)) !=
          cudaSuccess ||
      (err = plane_map(&maps.bl, p.bl, p.kp, p.ldb, Atom::COLS, WK, bsw)) !=
          cudaSuccess)
    return err;
  auto kern = wg_gemm_kernel<BN, FOLD, PASSES>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wg_smem(BN));
  if (err != cudaSuccess) return err;
  p.n_ct = (n_cols + BN - 1) / BN;
  const long long blocks = (long long)p.n_ct * ((p.M + WM - 1) / WM);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, 288, wg_smem(BN), s>>>(maps, p, epi);
  return cudaGetLastError();
}

// bytes of the split path's scratch: xn's and h's planes (lo only at 3
// passes)
long long wide_scratch(long long n_rows, int kp, int hp, int passes) {
  return (long long)halves(passes) * 2 * n_rows * (kp + hp);
}

template <int PASSES>
cudaError_t wide(const float* x, const float* mean, const float* dev,
                 const Slabs& w, const float* b1, const float* b2, float* out,
                 unsigned char* scratch, int n_rows, int n_inp, int n_hid,
                 int n_out, bool fast, bool softmax, cudaStream_t s) {
  const int kp = w.kp, hp = w.hp, op = w.op;
  bf16* xh = reinterpret_cast<bf16*>(scratch);
  bf16* xl = xh + (size_t)n_rows * kp;
  bf16* hh = xh + (size_t)halves(PASSES) * n_rows * kp;
  bf16* hl = hh + (size_t)n_rows * hp;
  const long long pairs = (long long)n_rows * (kp / 2);
  split_rows_kernel<<<(unsigned)std::min<long long>((pairs + 255) / 256,
                                                    132 * 16),
                      256, 0, s>>>(x, mean, dev, xh, xl, n_rows, n_inp, kp,
                                   PASSES == 3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  WgArgs p{};
  p.M = n_rows;
  p.fast = fast;
  // h = sigmoid(xn @ W1 + b1), split, into planes [n_rows, hp]
  p.ah = xh, p.al = xl, p.lda = kp, p.kp = kp;
  p.bh = w.w1h, p.bl = w.w1l, p.ldb = hp;
  p.bias = b1, p.n_valid = n_hid, p.ch = hh, p.cl = hl;
  err = wg_gemm<256, false, PASSES>(p, SPLIT, hp, s);
  if (err != cudaSuccess) return err;
  // o = h @ W2 + b2, one tile across all columns where they fit (the
  // softmax then in its epilogue), else tiles of 128 and the softmax apart
  p.ah = hh, p.al = hl, p.lda = hp, p.kp = hp;
  p.bh = w.w2h, p.bl = w.w2l, p.ldb = op;
  p.bias = b2, p.n_valid = n_out, p.c = out;
  if (op <= 144)
    return wg_gemm<144, true, PASSES>(p, softmax ? SOFTMAX : LOGITS, op, s);
  err = wg_gemm<128, true, PASSES>(p, LOGITS, op, s);
  if (err != cudaSuccess || !softmax) return err;
  softmax_rows_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, s>>>(
      out, n_rows, n_out, fast);
  return cudaGetLastError();
}

template <int RT, int NP, int PASSES, bool BANDS>
cudaError_t launch_one(const float* x, const float* mean, const float* dev,
                       const Slabs& w, const float* b1, const float* b2,
                       float* out, int n_rows, int n_inp, int n_hid,
                       int n_out, bool fast, bool softmax, int n_bands,
                       const Band& bd, cudaStream_t stream) {
  const size_t smem = smem_bytes(RT, w.kp, w.op, w.ks2, PASSES);
  auto kern = mlp_bf16x3_kernel<RT, NP, PASSES, BANDS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((n_rows + RT - 1) / RT), (unsigned)n_bands);
  kern<<<grid, RT / 16 * WS * 32, smem, stream>>>(
      x, mean, dev, w, b1, b2, out, n_rows, n_inp, n_hid, n_out, fast,
      softmax, bd);
  return cudaGetLastError();
}

template <int RT, int NP, int PASSES>
cudaError_t launch(const float* x, const float* mean, const float* dev,
                   const Slabs& w, const float* b1, const float* b2,
                   float* out, int n_rows, int n_inp, int n_hid, int n_out,
                   bool fast, bool softmax, int n_bands, const Band& bd,
                   cudaStream_t stream) {
  if (n_bands > 1)
    return launch_one<RT, NP, PASSES, true>(x, mean, dev, w, b1, b2, out,
                                            n_rows, n_inp, n_hid, n_out,
                                            fast, softmax, n_bands, bd,
                                            stream);
  return launch_one<RT, NP, PASSES, false>(x, mean, dev, w, b1, b2, out,
                                           n_rows, n_inp, n_hid, n_out, fast,
                                           softmax, 1, bd, stream);
}

// the 128-row tile with 64-unit W2 slabs where it fits and the call has
// more rows than one 64-row tile an SM, else the 64-row tile with 32-unit
// W2 slabs (every net up to MAX_INP x MAX_OUT fits it)
template <int PASSES>
cudaError_t dispatch(const float* x, const float* mean, const float* dev,
                     Slabs w, const float* b1, const float* b2, float* out,
                     int n_rows, int n_inp, int n_hid, int n_out, bool fast,
                     bool softmax, int n_bands, const Band& bd,
                     cudaStream_t s) {
  // the tile by the rows of all bands together
  const int npairs = w.op / 16;
  const bool wide_tile = npairs <= NP_NARROW &&
                         (long long)n_rows * n_bands >= WIDE_MIN_ROWS &&
                         smem_bytes(128, w.kp, w.op, 64, PASSES) <= SMEM_MAX;
  w.ks2 = wide_tile ? 64 : 32;
  w.ks1 = 2 * w.ks2;
  w.n1 = (w.kp + w.ks1 - 1) / w.ks1;
  w.per_chunk = w.n1 + HC / w.ks2;
  w.n_slabs = (n_hid + HC - 1) / HC * w.per_chunk;
  if (wide_tile)
    return launch<128, NP_NARROW, PASSES>(x, mean, dev, w, b1, b2, out,
                                          n_rows, n_inp, n_hid, n_out, fast,
                                          softmax, n_bands, bd, s);
  if (npairs <= NP_NARROW)
    return launch<64, NP_NARROW, PASSES>(x, mean, dev, w, b1, b2, out,
                                         n_rows, n_inp, n_hid, n_out, fast,
                                         softmax, n_bands, bd, s);
  return launch<64, NP_WIDE, PASSES>(x, mean, dev, w, b1, b2, out, n_rows,
                                     n_inp, n_hid, n_out, fast, softmax,
                                     n_bands, bd, s);
}

}  // namespace

extern "C" int phn_mlp_bf16x3_max_out() { return MAX_OUT; }
extern "C" int phn_mlp_bf16x3_max_inp() { return MAX_INP; }

namespace {

int fused(const void* x, const void* mean, const void* dev, const void* w1h,
          const void* w1l, const void* b1, const void* w2h, const void* w2l,
          const void* b2, void* out, int n_bands, int n_rows, int n_inp,
          int n_hid, int n_out, int fast, int softmax, int passes,
          void* stream) {
  if (n_rows <= 0 || n_bands <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_inp > MAX_INP || n_hid <= 0 || n_out <= 0 ||
      n_out > MAX_OUT || (passes != 1 && passes != 3) || n_bands > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1h) | reinterpret_cast<uintptr_t>(w1l) |
       reinterpret_cast<uintptr_t>(w2h) | reinterpret_cast<uintptr_t>(w2l)) %
          16 != 0)
    return cudaErrorInvalidValue;
  Slabs w{};
  w.w1h = static_cast<const bf16*>(w1h);
  w.w1l = static_cast<const bf16*>(w1l);
  w.w2h = static_cast<const bf16*>(w2h);
  w.w2l = static_cast<const bf16*>(w2l);
  w.kp = (n_inp + 15) / 16 * 16;
  w.hp = (n_hid + 127) / 128 * 128;
  w.op = (n_out + 15) / 16 * 16;
  // each band's weight halves start 16-byte aligned: kp * hp and hp * op
  // are multiples of 8 bf16
  const Band bd = n_bands == 1
                      ? Band{}
                      : Band{(long long)n_rows * n_inp, n_inp,
                             (long long)w.kp * w.hp, (long long)w.hp * w.op,
                             n_hid, n_out, (long long)n_rows * n_out};
  auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<const float*>(mean);
  auto* df = static_cast<const float*>(dev);
  auto* b1f = static_cast<const float*>(b1);
  auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return dispatch<3>(xf, mf, df, w, b1f, b2f, of, n_rows, n_inp, n_hid,
                       n_out, fast != 0, softmax != 0, n_bands, bd, s);
  return dispatch<1>(xf, mf, df, w, b1f, b2f, of, n_rows, n_inp, n_hid,
                     n_out, fast != 0, softmax != 0, n_bands, bd, s);
}

}  // namespace

// out[n_rows, n_out] = MLP(x[n_rows, n_inp]) with `passes` (1 or 3) bf16
// tensor-core passes per product.  x, mean, dev, b1, b2 float32 unpadded;
// w1h/w1l bf16 [kp, hp] and w2h/w2l bf16 [hp, op], zero-padded, with
// kp = round16(n_inp), hp = round128(n_hid), op = round16(n_out), each
// 16-byte aligned.  All contiguous on the current device.  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int phn_mlp_bf16x3(const void* x, const void* mean, const void* dev,
                              const void* w1h, const void* w1l, const void* b1,
                              const void* w2h, const void* w2l, const void* b2,
                              void* out, int n_rows, int n_inp, int n_hid,
                              int n_out, int fast, int softmax, int passes,
                              void* stream) {
  return fused(x, mean, dev, w1h, w1l, b1, w2h, w2l, b2, out, 1, n_rows,
               n_inp, n_hid, n_out, fast, softmax, passes, stream);
}

// A stack of n_bands nets of one topology in one launch: x [n_bands,
// n_rows, n_inp], mean and dev [n_bands, n_inp], w1h/w1l [n_bands, kp, hp],
// b1 [n_bands, n_hid], w2h/w2l [n_bands, hp, op], b2 [n_bands, n_out] ->
// out [n_bands, n_rows, n_out]; otherwise as phn_mlp_bf16x3.
extern "C" int phn_mlp_bf16x3_bands(const void* x, const void* mean,
                                    const void* dev, const void* w1h,
                                    const void* w1l, const void* b1,
                                    const void* w2h, const void* w2l,
                                    const void* b2, void* out, int n_bands,
                                    int n_rows, int n_inp, int n_hid,
                                    int n_out, int fast, int softmax,
                                    int passes, void* stream) {
  return fused(x, mean, dev, w1h, w1l, b1, w2h, w2l, b2, out, n_bands,
               n_rows, n_inp, n_hid, n_out, fast, softmax, passes, stream);
}

// Bytes of the split path's scratch for n_rows rows of a net.
extern "C" long long phn_mlp_bf16x3_wide_scratch(long long n_rows, int n_inp,
                                                 int n_hid, int passes) {
  return wide_scratch(n_rows, (n_inp + 15) / 16 * 16,
                      (n_hid + 127) / 128 * 128, passes);
}

// The split path for any widths: scratch holds phn_mlp_bf16x3_wide_scratch
// bytes, 16-byte aligned; otherwise as phn_mlp_bf16x3.  Three launches on
// `stream` (four where n_out > 144 with the softmax: it runs apart).
extern "C" int phn_mlp_bf16x3_wide(const void* x, const void* mean,
                                   const void* dev, const void* w1h,
                                   const void* w1l, const void* b1,
                                   const void* w2h, const void* w2l,
                                   const void* b2, void* out, void* scratch,
                                   int n_rows, int n_inp, int n_hid,
                                   int n_out, int fast, int softmax,
                                   int passes, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_hid <= 0 || n_out <= 0 || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1h) | reinterpret_cast<uintptr_t>(w1l) |
       reinterpret_cast<uintptr_t>(w2h) | reinterpret_cast<uintptr_t>(w2l) |
       reinterpret_cast<uintptr_t>(scratch)) %
          16 != 0)
    return cudaErrorInvalidValue;
  Slabs w{};
  w.w1h = static_cast<const bf16*>(w1h);
  w.w1l = static_cast<const bf16*>(w1l);
  w.w2h = static_cast<const bf16*>(w2h);
  w.w2l = static_cast<const bf16*>(w2l);
  w.kp = (n_inp + 15) / 16 * 16;
  w.hp = (n_hid + 127) / 128 * 128;
  w.op = (n_out + 15) / 16 * 16;
  auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<const float*>(mean);
  auto* df = static_cast<const float*>(dev);
  auto* b1f = static_cast<const float*>(b1);
  auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  auto* sc = static_cast<unsigned char*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return wide<3>(xf, mf, df, w, b1f, b2f, of, sc, n_rows, n_inp, n_hid,
                   n_out, fast != 0, softmax != 0, s);
  return wide<1>(xf, mf, df, w, b1f, b2f, of, sc, n_rows, n_inp, n_hid,
                 n_out, fast != 0, softmax != 0, s);
}
