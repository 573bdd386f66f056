// Fused 2-layer MLP forward, float32, for sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused (the Pallas
// kernel `_kernel`, with `_fexp`, `_sigmoid` and `_finish`).
//
//   xn = (x - mean) * dev
//   h  = sigmoid(xn @ W1 + b1)        (ICSI fast exp when `fast`)
//   o  = h @ W2 + b2
//   out = softmax(o) over the n_out columns (fast exp when `fast`), or o
//
// What bounds it on the H100: at the CZ shapes (165->1500->138 twice,
// 276->1500->138) the two GEMMs are ~1.5M multiply-adds per row against
// ~1.2 KB of input and output per row, so the chain is compute-bound once the
// [N, n_hid] hidden activations stay on chip.  The products are float32 FMAs
// (TF32 keeps too few mantissa bits; the bf16 split is mlp_bf16x3.cu), so the
// ceiling is the FP32 FMA rate (128 a clock an SM).  Two things keep a kernel
// from it.  An SM sub-partition issues one warp instruction a clock, so only
// the FMAs' share of the instruction stream can be FMAs.  And the operands
// come from shared memory at 128 bytes a clock an SM: a 16-byte load of a
// warp takes ~4 clocks (~2.5 when its lanes read at most 4 addresses), a
// 4-byte load ~1 (devtools/smem_microbench.py), so a thread tile of r x c
// accumulators costs about 4 (r + c) / (r c) bytes per FMA, and registers
// bound r c.
//
// Design: the register-tiled SGEMM structure, twice, chained through shared
// memory.  A block owns a tile of RT rows with 4 RT threads: 128 rows and
// 512 threads for large calls, 64 rows and 256 threads for small ones and for
// wide outputs.  It normalises its x tile once into shared memory,
// transposed ([k][row], zero past n_inp and past the last row), and walks
// the hidden axis in chunks of HC = 128 units.  One two-stage ring of slabs
// in shared memory, filled by the whole block with 16-byte cp.async while the
// slab before it is multiplied (one barrier a slab), carries the weights:
// per chunk the slabs [KS = 16][128] of W1[:, chunk], then the slabs
// [16][n_out] of W2[chunk, :] (contiguous spans of W2).
//
//   phase 1  pre[RT, 128] = xn @ W1[:, chunk].  A thread owns 4 rows x 8
//            hidden units: per k one 16-byte load of x and two of W1 feed 32
//            FMAs.
//   sigmoid  on the registers, + b1, stored to shared memory as [unit][row].
//   phase 2  o[RT, n_out] += h_chunk @ W2[chunk, :].  A warp owns 8 rows,
//            lane = output column, NQ columns a lane: per hidden unit two
//            16-byte broadcast loads of h and NQ loads of W2 feed 8 NQ FMAs.
//            The output accumulators stay in registers across all chunks.
//
// The hidden tensor never reaches device memory; W1 and W2 are read from L2
// once per RT rows.  The epilogue adds b2 and takes the row softmax with warp
// shuffles.  Every output element is one fmaf chain in ascending k (phase 1)
// and ascending hidden index (phase 2): no split of K, so the result does not
// depend on RT.  Padded k rows, hidden units and W2 rows are exact zeros in
// both operands.
//
// Budget a block (227 KB of dynamic shared memory, 65,536 registers an SM),
// floats: x tile round4(n_inp) * RT, h chunk 128 * (RT + 4), ring
// 2 * max(16 * 128, 16 * n_out + 256).  At RT = 128 the merger
// (276->1500->138) takes 228,608 bytes, one block of 16 warps an SM at up to
// 128 registers a thread (40 output and 32 phase-1 accumulators at NQ = 5); at
// RT = 64 a band net takes 98 KB, two blocks an SM.  The 128-row tile is
// taken when it fits, n_out <= 160 and the call has more rows than one 64-row
// tile an SM (WIDE_MIN_ROWS); otherwise the 64-row tile, which fits every
// n_inp <= MAX_INP = 480 at every n_out <= 256.
//
// Wider nets (n_inp > MAX_INP or n_out > 256: the 3BT / 1BT mergers,
// 1794 / 2070 -> 1500 -> 138) take a split path (phn_mlp_fused_wide), in a
// caller's scratch: xn^T = ((x - mean) * dev)^T [n_inp, n_rows]
// (transpose_norm_kernel, the norm applied once), the weights copied to
// rows of a multiple of 16 bytes, h^T = sigmoid(xn @ W1 + b1)^T, then o =
// h @ W2 + b2 with the row softmax.  Both products are float32 FMAs, so the
// FP32 rate bounds them (2 n (n_inp n_hid + n_hid n_out) operations: 11.07
// ms at the 3BT merger's 128,000 rows; the hidden tensor's round trip, 1.5
// GB, is 0.46 ms of bytes).  One register-tiled SGEMM (split_gemm_kernel)
// takes both: 256 threads a block, 8 x 8 sums a thread on a 128 x 128 tile
// (one shared-memory byte per FMA: two float4 of each operand feed 64
// FMAs), two blocks an SM.  Its operands arrive as [k][row] and [k][column]
// slabs, 16 deep, by TMA into a 5-stage ring (one mbarrier a stage, one
// block barrier a slab), which is why xn and h are kept transposed: the
// products read both as float4, conflict-free, with no pass over the slab
// in the loop.  (Fed by cp.async, 8-byte pieces of x's 7,176-byte rows and
// a transpose a slab, the first product took 24.5 ms, 11.8 of it without
// its FMAs; PERF.md.)  The second product runs one tile across all n_out
// columns where n_out <= 256 (128 x 144 or 64 x 256, a thread's columns tx
// + 16 j), and that tile's epilogue takes the row softmax as
// softmax_rows_kernel does (the logits through shared memory, a warp a
// row); wider outputs take 128 x 128 tiles and the softmax apart.  Every
// output is one fmaf chain in ascending k from 0 (TMA's zero fill past K
// in both operands), then the bias and activation: the order of the
// first split path (64 x 64 tiles, 4 x 4 sums a thread, synchronous
// loads), which this one equals bit for bit (devtools/mlp_variants.py
// --wide).
//
// A band stack (phn_mlp_fused_bands: the trap_bands band nets of the 3BT /
// 1BT systems, one topology, phnrec_tpu/posteriors/estimator.py:107-254)
// runs as one launch: a second grid dimension over the nets, each block
// advancing x, mean, dev, W1, b1, W2, b2 and out by its net's stride
// (Band) before it starts, so every net's rows are the single net's
// kernel above.  The band index is a template parameter (BANDS): the
// advanced pointers take registers (kernel params cost none), which
// spilled at the 128-row tile and cost the single net ~5% when every
// instance carried them.
//
// fexp follows phnrec_tpu/posteriors/fexp.py bit for bit: one float32
// multiply by the float32-rounded constant, a saturating truncation
// (__float2int_rz), a wrapping int32 add, and an exact 2^e that is 0 for
// e <= -126 (XLA on the CPU flushes there).  Build without --use_fast_math.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HC = 128;         // hidden units per chunk
constexpr int KS = 16;          // rows of W1 or W2 per slab of the ring
constexpr int MAX_NQ = 8;       // n_out <= 32 * MAX_NQ
constexpr int MAX_NQ_WIDE = 5;  // widest n_out / 32 the 128-row tile takes
constexpr int MAX_INP = 480;    // widest x tile the 64-row tile takes
constexpr int WIDE_MIN_ROWS = 64 * 132 + 1;   // one 64-row tile an SM
constexpr size_t SMEM_MAX = 232448;

constexpr float FEXP_A = 1512775.395195186f;   // 2^20 / ln 2, rounded to f32
constexpr unsigned FEXP_K = 1072693248u - 60801u;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// floats of one stage of the ring: a slab [KS][HC] of W1 or [KS][n_out] of
// W2, the latter with room for the lanes past n_out (up to 32 * MAX_NQ
// columns a row) to read on
__host__ __device__ constexpr int stage_floats(int n_out) {
  return KS * n_out + 32 * MAX_NQ > KS * HC ? round4(KS * n_out + 32 * MAX_NQ)
                                            : KS * HC;
}

// dynamic shared memory of a block, bytes
__host__ __device__ constexpr size_t smem_bytes(int rt, int n_inp, int n_out) {
  return sizeof(float) * ((size_t)round4(n_inp) * rt + (size_t)HC * (rt + 4) +
                          2 * stage_floats(n_out));
}
static_assert(smem_bytes(64, MAX_INP, 32 * MAX_NQ) <= SMEM_MAX,
              "MAX_INP does not fit the 64-row tile");

__device__ __forceinline__ float pow2_int(int e) {
  if (e <= -126) return 0.0f;
  if (e >= 128) return __int_as_float(0x7f800000);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float fexp(float y) {
  const int i = __float2int_rz(FEXP_A * y);               // saturates
  const int t = (int)((unsigned)i + FEXP_K);               // wraps
  const int e = (t >> 20) - 1023;
  // (float)(t & 0xFFFFF) without the conversion unit: 2^23 + n is exact
  const float n = __int_as_float(0x4B000000 | (t & 0xFFFFF)) - 8388608.0f;
  const float m = n * (1.0f / 1048576.0f);
  return pow2_int(e) * (1.0f + m);
}

__device__ __forceinline__ float sigmoid(float a, bool fast) {
  return 1.0f / (1.0f + (fast ? fexp(-a) : expf(-a)));
}

// Asynchronous global -> shared copies (LDGSTS).  dst and src must be
// aligned to the size copied.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 floats of a row of which the first n_valid (0..4) exist: copied if they
// do, zero if not.  vec: all 4 exist or none, src is 16-byte aligned.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int n_valid, bool vec) {
  if (vec && n_valid >= 4) {
    cp_async16(dst, src);
  } else if (n_valid <= 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n_valid)
        cp_async4(dst + e, src + e);
      else
        dst[e] = 0.0f;
    }
  }
}

// slab [KS][HC] of W1: rows k0.., columns j0.., zero past n_inp and n_hid
template <int NT>
__device__ __forceinline__ void load_w1_slab(float* dst, const float* w1,
                                             int k0, int j0, int n_inp,
                                             int n_hid, bool vec, int tid) {
#pragma unroll
  for (int idx = tid; idx < KS * HC / 4; idx += NT) {
    const int kk = idx / (HC / 4);
    const int c4 = (idx % (HC / 4)) * 4;
    const int k = k0 + kk;
    const int j = j0 + c4;
    const int n_valid = k < n_inp ? n_hid - j : 0;
    copy4(dst + kk * HC + c4, w1 + (size_t)k * n_hid + j, n_valid, vec);
  }
}

// slab [KS][n_out] of W2 from row j0, a contiguous span; zero past n_hid
template <int NT>
__device__ __forceinline__ void load_w2_slab(float* dst, const float* w2,
                                             int j0, int n_hid, int n_out,
                                             bool vec, int tid) {
  const float* src = w2 + (size_t)j0 * n_out;
  const int n_valid = min(KS, n_hid - j0) * n_out;
  for (int e = tid * 4; e < KS * n_out; e += NT * 4)
    copy4(dst + e, src + e, n_valid - e, vec);
}

// the elements between one band net's arrays and the next's (all zero for
// a single net)
struct Band {
  long long x, vec, w1, b1, w2, b2, out;
};

// fast and softmax are uniform over the grid: run-time flags, so that the
// source compiles one kernel per (RT, NQ) and band index or none
template <int RT, int NQ, bool BANDS>
__global__ void
__launch_bounds__(RT * 4, (RT == 64 && NQ <= MAX_NQ_WIDE) ? 2 : 1)
mlp_fused_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ dev, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out,
                 int n_rows, int n_inp, int n_hid, int n_out, bool fast,
                 bool softmax, const Band bd) {
  if (BANDS) {
    // this block's band net
    x += blockIdx.y * bd.x;
    mean += blockIdx.y * bd.vec;
    dev += blockIdx.y * bd.vec;
    w1 += blockIdx.y * bd.w1;
    b1 += blockIdx.y * bd.b1;
    w2 += blockIdx.y * bd.w2;
    b2 += blockIdx.y * bd.b2;
    out += blockIdx.y * bd.out;
  }
  constexpr int NT = RT * 4;     // threads per block
  constexpr int HS = RT + 4;     // row stride of the h chunk
  constexpr int R2 = 8;          // phase 2: rows per warp (x NQ columns)
  const int KP = round4(n_inp);
  const int stage = stage_floats(n_out);

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [KP][RT]
  float* hs = xs + (size_t)KP * RT;              // [HC][HS]
  float* ring = hs + HC * HS;                    // [2][stage]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * RT;

  // 16-byte copies where every piece of a row starts 16-byte aligned
  const bool vec1 = n_hid % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  const bool vec2 = reinterpret_cast<uintptr_t>(w2) % 16 == 0;

  // the ring carries, chunk after chunk, the n1 slabs of W1[:, chunk] and
  // then the slabs of W2[chunk, :]
  const int n1 = (n_inp + KS - 1) / KS;
  const int n_chunks = (n_hid + HC - 1) / HC;

  load_w1_slab<NT>(ring, w1, 0, 0, n_inp, n_hid, vec1, tid);
  cp_async_commit();

  // normalised x tile [k][row], zero past the last row and past n_inp; a
  // warp takes 32 rows of one k, so its stores do not collide
  for (int idx = tid; idx < RT * n_inp; idx += NT) {
    const int r = idx % RT;
    const int k = idx / RT;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n_rows) v = (x[row * n_inp + k] - mean[k]) * dev[k];
    xs[idx] = v;
  }
  for (int idx = RT * n_inp + tid; idx < RT * KP; idx += NT) xs[idx] = 0.0f;

  // phase-1 tile: units 4*hq.. and 64 + 4*hq.. of the chunk, rows 4*rg..:
  // a warp reads 8 neighbouring float4 of x and, twice, 4 of W1 (the cheaper
  // pattern for the operand with two loads)
  const int hq = (warp & 3) * 4 + (lane >> 3);
  const int rg = (warp >> 2) * 8 + (lane & 7);
  // phase-2 tile: rows orow.., columns lane + 32*q
  const int orow = warp * R2;

  float acc[NQ][R2];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < R2; ++i) acc[q][i] = 0.0f;

  int it = 0;   // slabs consumed so far: slab `it` sits in stage it & 1
  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * HC;
    const int n2 = (min(HC, n_hid - j0) + KS - 1) / KS;
    float a[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) a[i][u] = 0.0f;

    for (int t = 0; t < n1 + n2; ++t, ++it) {
      cp_async_wait<0>();
      __syncthreads();
      // slab `it` has landed and every thread is past slab it-1: the other
      // stage is free for the slab after this one
      float* next = ring + ((it + 1) & 1) * stage;
      if (t + 1 < n1)
        load_w1_slab<NT>(next, w1, (t + 1) * KS, j0, n_inp, n_hid, vec1, tid);
      else if (t + 1 < n1 + n2)
        load_w2_slab<NT>(next, w2, j0 + (t + 1 - n1) * KS, n_hid, n_out, vec2,
                     tid);
      else if (c + 1 < n_chunks)
        load_w1_slab<NT>(next, w1, 0, j0 + HC, n_inp, n_hid, vec1, tid);
      cp_async_commit();
      const float* slab = ring + (it & 1) * stage;

      if (t < n1) {
        const int kn = min(KS, KP - t * KS);   // a multiple of 4
        const float* xp = xs + (size_t)(t * KS) * RT + rg * 4;
        const float* wp = slab + hq * 4;
#pragma unroll 4
        for (int kk = 0; kk < kn; kk += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 wa =
                *reinterpret_cast<const float4*>(wp + (kk + u) * HC);
            const float4 wb =
                *reinterpret_cast<const float4*>(wp + (kk + u) * HC + 64);
            const float w[8] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
            const float4 x4 =
                *reinterpret_cast<const float4*>(xp + (kk + u) * RT);
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int v = 0; v < 8; ++v)
                a[i][v] = fmaf(xv[i], w[v], a[i][v]);
          }
        }
        if (t == n1 - 1) {
          // sigmoid on the registers; units past n_hid are 0
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int jl = (v < 4 ? 0 : 60) + hq * 4 + v;
            const bool live = j0 + jl < n_hid;
            const float bj = live ? __ldg(b1 + j0 + jl) : 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i][v] = live ? sigmoid(a[i][v] + bj, fast) : 0.0f;
            *reinterpret_cast<float4*>(hs + jl * HS + rg * 4) =
                make_float4(a[0][v], a[1][v], a[2][v], a[3][v]);
          }
          // the next slab's barrier comes before phase 2 reads hs
        }
      } else {
        // rows of W2 past n_hid and their h are zero in the slab and in hs
        const float* hp = hs + (size_t)((t - n1) * KS) * HS + orow;
        const float* w2p = slab + lane;
#pragma unroll 4
        for (int e = 0; e < KS; ++e) {
          float hv[R2];
#pragma unroll
          for (int i = 0; i < R2; i += 4) {
            const float4 t4 =
                *reinterpret_cast<const float4*>(hp + e * HS + i);
            hv[i] = t4.x;
            hv[i + 1] = t4.y;
            hv[i + 2] = t4.z;
            hv[i + 3] = t4.w;
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            // lanes past n_out read on into the next row or the stage's
            // tail (finite or not); their sums are never used
            const float w = w2p[e * n_out + 32 * q];
#pragma unroll
            for (int i = 0; i < R2; ++i)
              acc[q][i] = fmaf(hv[i], w, acc[q][i]);
          }
        }
      }
    }
  }

  float bias[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int o = lane + 32 * q;
    bias[q] = o < n_out ? __ldg(b2 + o) : 0.0f;
  }

#pragma unroll
  for (int i = 0; i < R2; ++i) {
    const long long row = row0 + orow + i;
    float v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = acc[q][i] + bias[q];
    if (softmax) {
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (lane + 32 * q < n_out) mx = fmaxf(mx, v[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float s = v[q] - mx;
        const float e = fast ? fexp(s) : expf(s);
        v[q] = lane + 32 * q < n_out ? e : 0.0f;
        sum += v[q];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int q = 0; q < NQ; ++q) v[q] = v[q] / sum;
    }
    if (row < n_rows) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int o = lane + 32 * q;
        if (o < n_out) out[row * n_out + o] = v[q];
      }
    }
  }
}

// The split path's products: a register-tiled SGEMM fed by TMA.  c =
// act(a @ w + bias) with a given transposed, aT [K, lda] (lda >= M, a
// multiple of 4), and w [K, ldw] row-major, both float32.  A block of 256
// threads owns a tile of BM = 16 TR rows by BN = 16 NC columns, a thread TR
// rows (ty * 4 + 64 g + 0..3) by NC columns (VB: tx * 4 + 64 h + 0..3, two
// float4 of a slab row; else tx + 16 j, one float each).
constexpr int SK = 16;   // depth of a slab (the old split path's too)
constexpr int SS = 5;    // stages of the ring

enum Epilogue { SIGMOID, LOGITS, SOFTMAX };

template <int TR, int NC>
struct SplitTile {
  static constexpr int BM = 16 * TR;
  static constexpr int BN = 16 * NC;
  static constexpr int STAGE = SK * (BM + BN);   // floats: aT, then w
  // the ring, its mbarriers and room to align the base to 128 bytes
  static constexpr size_t SMEM = sizeof(float) * SS * STAGE + 8 * SS + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
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

// Slab t (rows 16 t.. of aT and w) into stage s: the boxes [SK][BM] of aT
// from column row0 and [SK][BN] of w from column col0; TMA zero-fills past
// K and the arrays' widths
template <int TR, int NC>
__device__ __forceinline__ void issue_slab(uint32_t ring, uint32_t bars,
                                           const CUtensorMap* ma,
                                           const CUtensorMap* mw, int row0,
                                           int col0, int t) {
  using T = SplitTile<TR, NC>;
  const int s = t % SS;
  const uint32_t st = ring + sizeof(float) * s * T::STAGE;
  mbar_expect(bars + 8 * s, sizeof(float) * T::STAGE);
  tma_load(st, ma, row0, t * SK, bars + 8 * s);
  tma_load(st + sizeof(float) * SK * T::BM, mw, col0, t * SK, bars + 8 * s);
}

// The ring: thread 0 keeps SS - 1 slabs in flight ahead of the one being
// multiplied (slab t + SS goes into slab t's stage once every thread is
// past it: one block barrier a slab); every thread waits on a slab's
// mbarrier.  The products read both operands as float4 from the [k][row]
// and [k][column] slabs, conflict-free.
template <int TR, int NC, bool VB>
__global__ void __launch_bounds__(256, 2)
split_gemm_kernel(const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ bias, float* __restrict__ c,
                  int M, int K, int N, int ldc, int n_ct, Epilogue epi,
                  bool fast) {
  using T = SplitTile<TR, NC>;
  static_assert(!VB || NC == 8, "float4 columns take NC = 8");
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(       // [SS][STAGE]
      (reinterpret_cast<uintptr_t>(smem4) + 127) & ~uintptr_t(127));
  const uint32_t ring_a = smem_u32(ring);
  const uint32_t bars = ring_a + sizeof(float) * SS * T::STAGE;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // column tiles vary fastest: the blocks of one row tile share its a slabs
  // in L2
  const int col0 = (int)(blockIdx.x % n_ct) * T::BN;
  const int row0 = (int)(blockIdx.x / n_ct) * T::BM;
  const int n_slabs = (K + SK - 1) / SK;

  if (tid == 0) {
    for (int s = 0; s < SS; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < SS && t < n_slabs; ++t)
      issue_slab<TR, NC>(ring_a, bars, &ma, &mw, row0, col0, t);
  }
  __syncthreads();

  float acc[TR][NC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_slabs; ++t) {
    mbar_wait(bars + 8 * (t % SS), (t / SS) & 1);
    const float* at = ring + (t % SS) * T::STAGE + ty * 4;
    const float* ws = ring + (t % SS) * T::STAGE + SK * T::BM;
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float av[TR], wv[NC];
#pragma unroll
      for (int g = 0; g < TR / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(at + kk * T::BM + 64 * g);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
      if (VB) {
#pragma unroll
        for (int h = 0; h < NC / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + kk * T::BN + tx * 4 + 64 * h);
          wv[4 * h] = v.x;
          wv[4 * h + 1] = v.y;
          wv[4 * h + 2] = v.z;
          wv[4 * h + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) wv[j] = ws[kk * T::BN + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    // every thread is past slab t: its stage takes slab t + SS
    __syncthreads();
    if (tid == 0 && t + SS < n_slabs)
      issue_slab<TR, NC>(ring_a, bars, &ma, &mw, row0, col0, t + SS);
  }

  // the thread's rows and columns
  auto row_of = [&](int i) { return ty * 4 + 64 * (i / 4) + (i % 4); };
  auto col_of = [&](int j) {
    return VB ? tx * 4 + 64 * (j / 4) + (j % 4) : tx + 16 * j;
  };
  float bj[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = col0 + col_of(j);
    bj[j] = col < N ? __ldg(bias + col) : 0.0f;
  }
  if (epi == SIGMOID) {
    // h, transposed: c [N, ldc], four rows a float4 (rows up to ldc, a
    // multiple of 4, all finite)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = col0 + col_of(j);
      if (col >= N) continue;
#pragma unroll
      for (int g = 0; g < TR / 4; ++g) {
        const int row = row0 + ty * 4 + 64 * g;
        if (row >= ldc) continue;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = sigmoid(acc[4 * g + e][j] + bj[j], fast);
        *reinterpret_cast<float4*>(c + (size_t)col * ldc + row) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    return;
  }
  if (epi == LOGITS) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const long long row = row0 + row_of(i);
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = col0 + col_of(j);
        if (col < N) c[row * N + col] = acc[i][j] + bj[j];
      }
    }
    return;
  }

  // one tile holds every column of its rows (N <= BN): the logits into
  // shared memory, then a warp a row takes the softmax exactly as
  // softmax_rows_kernel does.  The float4-column tiles never take it.
  if constexpr (!VB) {
    constexpr int LD = T::BN + 1;
    static_assert(T::BM * LD <= SS * T::STAGE, "logits do not fit the ring");
    float* lg = ring;   // every thread is past the last slab's barrier
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        lg[row_of(i) * LD + col_of(j)] = acc[i][j] + bj[j];
    __syncthreads();
    const int lane = tid & 31;
    for (int r = tid >> 5; r < T::BM; r += 8) {
      const long long row = row0 + r;
      if (row >= M) break;
      float* v = lg + r * LD;
      float mx = -INFINITY;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, v[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int j = lane; j < N; j += 32) {
        const float e = fast ? fexp(v[j] - mx) : expf(v[j] - mx);
        v[j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int j = lane; j < N; j += 32) c[row * N + j] = v[j] / sum;
    }
  }
}

// xnT [K, ldt] = ((x - mean) * dev)^T for x [M, K] (x^T where mean is
// null), zero in the columns M..ldt: 32 x 32 tiles through shared memory
__global__ void __launch_bounds__(256)
transpose_norm_kernel(const float* __restrict__ x,
                      const float* __restrict__ mean,
                      const float* __restrict__ dev, float* __restrict__ xt,
                      int M, int K, int ldt) {
  __shared__ float tile[32][33];
  const long long r0 = (long long)blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const long long row = r0 + i;
    const int k = k0 + threadIdx.x;
    float v = 0.0f;
    if (row < M && k < K) {
      v = x[row * K + k];
      if (mean) v = (v - mean[k]) * dev[k];
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i;
    const long long row = r0 + threadIdx.x;
    if (k < K && row < ldt) xt[(size_t)k * ldt + row] = tile[threadIdx.x][i];
  }
}

// dst [rows, ldd] = src [rows, cols] zero-padded to ldd columns
__global__ void __launch_bounds__(256)
pad_cols_kernel(const float* __restrict__ src, float* __restrict__ dst,
                int rows, int cols, int ldd) {
  const long long n = (long long)rows * ldd;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    const long long r = i / ldd;
    const int col = (int)(i % ldd);
    dst[i] = col < cols ? src[r * cols + col] : 0.0f;
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

// a float32 array [rows, cols] row-major, boxes of box_cols x SK rows
cudaError_t f32_map(CUtensorMap* m, const float* base, int rows, int cols,
                    int box_cols) {
  const PFN_cuTensorMapEncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)SK};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// c = act(a @ w + bias) with aT [K, lda] and w [K, ldw] (zero past N)
template <int TR, int NC, bool VB>
cudaError_t split_gemm(const float* at, int lda, const float* w, int ldw,
                       const float* bias, float* c, int ldc, int M, int K,
                       int N, Epilogue epi, bool fast, cudaStream_t s) {
  using T = SplitTile<TR, NC>;
  CUtensorMap ma, mw;
  cudaError_t err = f32_map(&ma, at, K, lda, T::BM);
  if (err == cudaSuccess) err = f32_map(&mw, w, K, ldw, T::BN);
  if (err != cudaSuccess) return err;
  auto kern = split_gemm_kernel<TR, NC, VB>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const long long n_ct = (N + T::BN - 1) / T::BN;
  const long long blocks = n_ct * ((M + T::BM - 1) / T::BM);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, 256, T::SMEM, s>>>(ma, mw, bias, c, M, K, N, ldc,
                                              (int)n_ct, epi, fast);
  return cudaGetLastError();
}

// the split path's scratch, floats: xn^T [n_inp, round4(n_rows)], h^T
// [n_hid, round4(n_rows)], W1 [n_inp, round4(n_hid)], W2 [n_hid,
// round4(n_out)]
long long wide_scratch(long long n_rows, int n_inp, int n_hid, int n_out) {
  return (n_rows + 3) / 4 * 4 * (n_inp + n_hid) +
         (long long)n_inp * round4(n_hid) + (long long)n_hid * round4(n_out);
}

template <int RT, int NQ, bool BANDS>
cudaError_t launch(const float* x, const float* mean, const float* dev,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, int n_rows, int n_inp,
                   int n_hid, int n_out, bool fast, bool softmax,
                   int n_bands, const Band& bd, cudaStream_t stream) {
  const size_t smem = smem_bytes(RT, n_inp, n_out);
  auto kern = mlp_fused_kernel<RT, NQ, BANDS>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((n_rows + RT - 1) / RT), (unsigned)n_bands);
  kern<<<grid, RT * 4, smem, stream>>>(x, mean, dev, w1, b1, w2, b2, out,
                                       n_rows, n_inp, n_hid, n_out, fast,
                                       softmax, bd);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* x, const float* mean, const float* dev,
                     const float* w1, const float* b1, const float* w2,
                     const float* b2, float* out, int n_rows, int n_inp,
                     int n_hid, int n_out, bool fast, bool softmax,
                     int n_bands, const Band& bd, cudaStream_t s) {
  // columns a lane: n_out / 32 rounded up to one of 4, 5, 6, 8 (a kernel is
  // compiled for each; the columns past n_out are masked); the tile by
  // the rows of all bands together
  const int cols = (n_out + 31) / 32;
  const int nq = cols <= 4 ? 4 : cols <= 6 ? cols : 8;
  const bool wide = nq <= MAX_NQ_WIDE &&
                    (long long)n_rows * n_bands >= WIDE_MIN_ROWS &&
                    smem_bytes(128, n_inp, n_out) <= SMEM_MAX;
#define PHN_CASE(RT, N)                                                   \
  case N:                                                                 \
    return n_bands > 1                                                    \
               ? launch<RT, N, true>(x, mean, dev, w1, b1, w2, b2, out,   \
                                     n_rows, n_inp, n_hid, n_out, fast,   \
                                     softmax, n_bands, bd, s)             \
               : launch<RT, N, false>(x, mean, dev, w1, b1, w2, b2, out,  \
                                      n_rows, n_inp, n_hid, n_out, fast,  \
                                      softmax, 1, bd, s);
  if (wide) {
    switch (nq) {
      PHN_CASE(128, 4) PHN_CASE(128, 5)
    }
  }
  switch (nq) {
    PHN_CASE(64, 4) PHN_CASE(64, 5) PHN_CASE(64, 6) PHN_CASE(64, 8)
  }
#undef PHN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int phn_mlp_fused_max_out() { return 32 * MAX_NQ; }
extern "C" int phn_mlp_fused_max_inp() { return MAX_INP; }

// out[n_rows, n_out] = MLP(x[n_rows, n_inp]); w1 is [n_inp, n_hid], w2 is
// [n_hid, n_out], all float32, contiguous, on the current device.  Launches
// on `stream`, allocates nothing, does not synchronise.
extern "C" int phn_mlp_fused(const void* x, const void* mean, const void* dev,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int n_rows, int n_inp,
                             int n_hid, int n_out, int fast, int softmax,
                             void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_inp > MAX_INP || n_hid <= 0 || n_out <= 0 ||
      n_out > 32 * MAX_NQ)
    return cudaErrorInvalidValue;
  return dispatch(static_cast<const float*>(x),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(dev),
                  static_cast<const float*>(w1),
                  static_cast<const float*>(b1),
                  static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(out),
                  n_rows, n_inp, n_hid, n_out, fast != 0, softmax != 0, 1,
                  Band{}, static_cast<cudaStream_t>(stream));
}

// A stack of n_bands nets of one topology in one launch: x [n_bands,
// n_rows, n_inp], mean and dev [n_bands, n_inp], w1 [n_bands, n_inp,
// n_hid], b1 [n_bands, n_hid], w2 [n_bands, n_hid, n_out], b2 [n_bands,
// n_out] -> out [n_bands, n_rows, n_out]; otherwise as phn_mlp_fused.
extern "C" int phn_mlp_fused_bands(const void* x, const void* mean,
                                   const void* dev, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* out, int n_bands,
                                   int n_rows, int n_inp, int n_hid,
                                   int n_out, int fast, int softmax,
                                   void* stream) {
  if (n_rows <= 0 || n_bands <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_inp > MAX_INP || n_hid <= 0 || n_out <= 0 ||
      n_out > 32 * MAX_NQ || n_bands > 65535)
    return cudaErrorInvalidValue;
  const Band bd{(long long)n_rows * n_inp, n_inp, (long long)n_inp * n_hid,
                n_hid, (long long)n_hid * n_out, n_out,
                (long long)n_rows * n_out};
  return dispatch(static_cast<const float*>(x),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(dev),
                  static_cast<const float*>(w1),
                  static_cast<const float*>(b1),
                  static_cast<const float*>(w2),
                  static_cast<const float*>(b2), static_cast<float*>(out),
                  n_rows, n_inp, n_hid, n_out, fast != 0, softmax != 0,
                  n_bands, bd, static_cast<cudaStream_t>(stream));
}

// Bytes of the split path's scratch for n_rows rows of a net.
extern "C" long long phn_mlp_fused_wide_scratch(long long n_rows, int n_inp,
                                                int n_hid, int n_out) {
  return (long long)sizeof(float) * wide_scratch(n_rows, n_inp, n_hid, n_out);
}

// The split path for any widths: scratch holds phn_mlp_fused_wide_scratch
// bytes, 16-byte aligned; otherwise as phn_mlp_fused.  Five launches on
// `stream` (six where n_out > 256: the softmax apart): xn^T, the weights
// padded to rows of a multiple of 16 bytes (what TMA takes), h^T, o.
extern "C" int phn_mlp_fused_wide(const void* x, const void* mean,
                                  const void* dev, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, void* scratch,
                                  int n_rows, int n_inp, int n_hid, int n_out,
                                  int fast, int softmax, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_hid <= 0 || n_out <= 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      n_rows > (1 << 30))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int ldt = round4(n_rows);
  const int lh = round4(n_hid), lo = round4(n_out);
  float* xt = static_cast<float*>(scratch);
  float* ht = xt + (size_t)ldt * n_inp;
  float* w1p = ht + (size_t)ldt * n_hid;
  float* w2p = w1p + (size_t)n_inp * lh;
  auto* o = static_cast<float*>(out);
  const bool f = fast != 0;
  transpose_norm_kernel<<<dim3((unsigned)(ldt + 31) / 32,
                               (unsigned)(n_inp + 31) / 32),
                          dim3(32, 8), 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(dev), xt, n_rows, n_inp, ldt);
  pad_cols_kernel<<<132 * 8, 256, 0, s>>>(static_cast<const float*>(w1), w1p,
                                          n_inp, n_hid, lh);
  pad_cols_kernel<<<132 * 8, 256, 0, s>>>(static_cast<const float*>(w2), w2p,
                                          n_hid, n_out, lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = split_gemm<8, 8, true>(xt, ldt, w1p, lh,
                               static_cast<const float*>(b1), ht, ldt, n_rows,
                               n_inp, n_hid, SIGMOID, f, s);
  if (err != cudaSuccess) return err;
  // the output product: one tile across all n_out columns where they fit
  // (the softmax then in its epilogue), else 128-column tiles and the
  // softmax apart
  auto* b2f = static_cast<const float*>(b2);
  const Epilogue epi = softmax ? SOFTMAX : LOGITS;
  if (n_out <= SplitTile<8, 9>::BN)
    return split_gemm<8, 9, false>(ht, ldt, w2p, lo, b2f, o, n_out, n_rows,
                                   n_hid, n_out, epi, f, s);
  if (n_out <= SplitTile<4, 16>::BN)
    return split_gemm<4, 16, false>(ht, ldt, w2p, lo, b2f, o, n_out, n_rows,
                                    n_hid, n_out, epi, f, s);
  err = split_gemm<8, 8, true>(ht, ldt, w2p, lo, b2f, o, n_out, n_rows, n_hid,
                               n_out, LOGITS, f, s);
  if (err != cudaSuccess || !softmax) return err;
  softmax_rows_kernel<<<(unsigned)((n_rows + 7) / 8), 256, 0, s>>>(
      o, n_rows, n_out, f);
  return cudaGetLastError();
}
