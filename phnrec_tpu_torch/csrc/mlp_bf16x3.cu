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
// Wider nets (n_inp > MAX_INP or n_out > MAX_OUT) take a split path,
// three launches on the stream (phn_mlp_bf16x3_wide), as kernel A's: h =
// sigmoid(xn @ W1 + b1) into a caller's [n_rows, n_hid] float32 scratch
// tensor, o = h @ W2 + b2 into the output, then the row softmax in place.
// Both products are one tensor-core kernel (gemm_kernel): a 64 x 64 output
// tile a block of 4 warps, each warp 16 rows by 64 columns; 32-deep slabs,
// the float32 operand (xn or h) split into bf16 hi and lo as it is staged,
// the weights' hi and lo staged as given, the same passes in the same
// order (hi.hi, hi.lo, lo.hi at each 16-deep step) and each slab's sum
// folded into a float32 total, as the fused kernel folds h @ W2.  The
// hidden tensor makes a round trip through device memory: these widths
// are off the main path.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// The split path's product: c[M, N] = act(split(a') @ w + bias), a' = (a -
// mean) * dev by column where mean is given, else a; a [M, K] float32, w
// as hi and lo bf16 [kp, np] row-major, zero past K and N (np a multiple of
// 16, so every 16-byte piece of a row exists or none does).
constexpr int GT = 64;         // output tile, rows and columns
constexpr int GK = 32;         // depth of a slab
constexpr int GA_LD = GK + 8;  // row stride of the split a slab, bf16
constexpr int GW_LD = GT + 8;  // row stride of a weight slab, bf16

template <int PASSES>
__global__ void __launch_bounds__(128)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ mean,
            const float* __restrict__ dev, const bf16* __restrict__ wh,
            const bf16* __restrict__ wl, int kp, int np,
            const float* __restrict__ bias, float* __restrict__ c, int M,
            int K, int N, bool sigm, bool fast) {
  __shared__ __align__(16) bf16 sa[2][GT * GA_LD];   // [row][k], hi and lo
  __shared__ __align__(16) bf16 sw[2][GK * GW_LD];   // [k][column]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
  const long long row0 = (long long)blockIdx.x * GT;
  const int col0 = blockIdx.y * GT;
  float acc[4][2][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += GK) {
    // a: 32 consecutive k of a row, split
    for (int e = tid; e < GT * GK; e += 128) {
      const int r = e / GK, kk = e % GK;
      const long long row = row0 + r;
      const int k = k0 + kk;
      float v = 0.0f;
      if (row < M && k < K) {
        v = a[row * K + k];
        if (mean) v = (v - mean[k]) * dev[k];
      }
      const bf16 h = __float2bfloat16_rn(v);
      sa[0][r * GA_LD + kk] = h;
      if (PASSES == 3)
        sa[1][r * GA_LD + kk] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
    // w: 16-byte pieces, 8 columns each, zero past kp and np
    for (int e = tid; e < halves(PASSES) * GK * (GT / 8); e += 128) {
      const int hf = e / (GK * (GT / 8));
      const int r = (e / (GT / 8)) % GK, q = e % (GT / 8);
      const int k = k0 + r, col = col0 + 8 * q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < kp && col < np)
        v = *reinterpret_cast<const uint4*>((hf ? wl : wh) +
                                            (size_t)k * np + col);
      *reinterpret_cast<uint4*>(&sw[hf][r * GW_LD + 8 * q]) = v;
    }
    __syncthreads();
    float sum[4][2][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[p][n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < GK; ks += 16) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, &sa[0][(16 * warp + lrow) * GA_LD + ks + lcol]);
      if (PASSES == 3) ldsm_x4(al, &sa[1][(16 * warp + lrow) * GA_LD + ks + lcol]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, &sw[0][(ks + lrow) * GW_LD + 16 * p + lcol]);
        if (PASSES == 3)
          ldsm_x4_t(bl, &sw[1][(ks + lrow) * GW_LD + 16 * p + lcol]);
        mma_passes<PASSES>(sum[p], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][n][e] += sum[p][n][e];
    __syncthreads();
  }
  // (c0, c1) row g, columns 2t and 2t + 1 of an n8 tile; (c2, c3) row g + 8
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = row0 + 16 * warp + g + 8 * (e >> 1);
        const int col = col0 + 16 * p + 8 * n + 2 * t4 + (e & 1);
        if (row < M && col < N) {
          const float v = acc[p][n][e] + bias[col];
          c[row * N + col] = sigm ? sigmoid(v, fast) : v;
        }
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

template <int PASSES>
cudaError_t wide(const float* x, const float* mean, const float* dev,
                 const Slabs& w, const float* b1, const float* b2, float* out,
                 float* hid, int n_rows, int n_inp, int n_hid, int n_out,
                 bool fast, bool softmax, cudaStream_t s) {
  const unsigned rt = (unsigned)((n_rows + GT - 1) / GT);
  gemm_kernel<PASSES><<<dim3(rt, (unsigned)((n_hid + GT - 1) / GT)), 128, 0,
                        s>>>(x, mean, dev, w.w1h, w.w1l, w.kp, w.hp, b1, hid,
                             n_rows, n_inp, n_hid, true, fast);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_kernel<PASSES><<<dim3(rt, (unsigned)((n_out + GT - 1) / GT)), 128, 0,
                        s>>>(hid, nullptr, nullptr, w.w2h, w.w2l, w.hp, w.op,
                             b2, out, n_rows, n_hid, n_out, false, fast);
  err = cudaGetLastError();
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

// The split path for any widths: hid is an [n_rows, n_hid] float32 scratch
// tensor; otherwise as phn_mlp_bf16x3.  Three launches on `stream`.
extern "C" int phn_mlp_bf16x3_wide(const void* x, const void* mean,
                                   const void* dev, const void* w1h,
                                   const void* w1l, const void* b1,
                                   const void* w2h, const void* w2l,
                                   const void* b2, void* out, void* hid,
                                   int n_rows, int n_inp, int n_hid,
                                   int n_out, int fast, int softmax,
                                   int passes, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_hid <= 0 || n_out <= 0 || (passes != 1 && passes != 3) ||
      n_hid > 65535 * GT || n_out > 65535 * GT)
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
  auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<const float*>(mean);
  auto* df = static_cast<const float*>(dev);
  auto* b1f = static_cast<const float*>(b1);
  auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  auto* hf = static_cast<float*>(hid);
  auto s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return wide<3>(xf, mf, df, w, b1f, b2f, of, hf, n_rows, n_inp, n_hid,
                   n_out, fast != 0, softmax != 0, s);
  return wide<1>(xf, mf, df, w, b1f, b2f, of, hf, n_rows, n_inp, n_hid,
                 n_out, fast != 0, softmax != 0, s);
}
