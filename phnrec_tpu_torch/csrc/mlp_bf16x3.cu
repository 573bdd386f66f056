// Fused 2-layer MLP forward on bf16 tensor cores (3 passes or 1), for
// sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused at
// Precision.HIGH (the Pallas kernel `_kernel3`, with `_split_bf16` and
// `_dot3`).  The chain is kernel A's (csrc/mlp_fused.cu):
//
//   xn = (x - mean) * dev
//   h  = sigmoid(xn @ W1 + b1)        (ICSI fast exp when FAST)
//   o  = h @ W2 + b2
//   out = softmax(o) over the n_out columns (fast exp when FAST), or o
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
// What bounds it on the H100: at the CZ shapes the three passes are
// ~4.4M bf16 multiply-adds per row against ~1.2 KB of input and output, so
// the chain is compute-bound on the tensor cores once the [N, n_hid]
// hidden tensor stays on chip (989 TFLOP/s dense bf16, 700 W).
//
// Design (simple first: nvcuda::wmma 16x16x16 bf16 fragments, no TMA, no
// wgmma, no pipelining).  A block of 8 warps owns 64 rows (4 row tiles).
// It normalises and splits its x tile once into shared memory (hi and lo,
// [64][kp+8] bf16).  Then it walks the hidden axis in chunks of 128 units:
//   1. each warp owns 16 hidden units of the chunk and all 4 row tiles: per
//      k-step it loads its W1 fragments (hi, lo) from global memory once
//      and runs the passes against the 4 row tiles' x fragments;
//   2. the pre-activations go through shared memory (float32), where b1,
//      the sigmoid and the hi/lo split of h are applied elementwise;
//   3. each warp accumulates h_chunk @ W2[chunk, :] into its output tiles
//      (one row tile, every other column tile), kept in registers.
// Each fragment's tensor-core sum is kept short (4 k-steps for xn @ W1, one
// chunk of 8 k-steps for h @ W2) and added into a float32 total with an
// ordinary rounded add: the tensor cores' internal accumulation is not
// round-to-nearest, so long chains inside them would drift.  The hidden
// tensor never reaches device memory.  The epilogue stages the output tile
// in shared memory (over the x tile) and is kernel A's: + b2, then the row
// softmax with warp shuffles, or the raw logits.
//
// fexp follows phnrec_tpu/posteriors/fexp.py bit for bit, as in kernel A.
// Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int RT = 64;                      // rows per block
constexpr int RTILES = RT / 16;             // row tiles per block
constexpr int HC = 128;                     // hidden units per chunk
constexpr int NW = 8;                       // warps per block (HC / 16)
constexpr int NT = NW * 32;
constexpr int KG = 64;                      // K per tensor-core partial sum
constexpr int MAX_OT = 12;                  // output column tiles: n_out <= 192
constexpr int MAX_PPW = RTILES * MAX_OT / NW;   // output tiles per warp
constexpr int MAX_NQ = 16 * MAX_OT / 32;    // output columns per lane
constexpr int MAX_INP = 512;
constexpr int HS_LD = HC + 4;               // float32 pre-activation stage
constexpr int HH_LD = HC + 8;               // bf16 hidden halves

static_assert(NW * 16 == HC, "one 16-unit hidden tile per warp");
static_assert(NW % RTILES == 0, "warps share row tiles evenly");

constexpr float FEXP_A = 1512775.395195186f;   // 2^20 / ln 2, rounded to f32
constexpr unsigned FEXP_K = 1072693248u - 60801u;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory, in bytes: region 0 holds the x halves and later the output
// tile; every region starts on a 128-byte boundary.
struct Layout {
  size_t hs, hh, hl, total;
};

__host__ __device__ inline size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ inline Layout layout(int kp, int op) {
  const size_t x_bytes = (size_t)2 * RT * (kp + 8) * sizeof(__nv_bfloat16);
  const size_t o_bytes = (size_t)RT * (op + 4) * sizeof(float);
  Layout l;
  l.hs = round128(x_bytes > o_bytes ? x_bytes : o_bytes);
  l.hh = l.hs + round128((size_t)RT * HS_LD * sizeof(float));
  l.hl = l.hh + round128((size_t)RT * HH_LD * sizeof(__nv_bfloat16));
  l.total = l.hl + round128((size_t)RT * HH_LD * sizeof(__nv_bfloat16));
  return l;
}

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

template <bool FAST>
__device__ __forceinline__ float sigmoid(float a) {
  return FAST ? 1.0f / (1.0f + fexp(-a)) : 1.0f / (1.0f + expf(-a));
}

__device__ __forceinline__ void split(float v, __nv_bfloat16* hi,
                                      __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *hi = h;
  *lo = __float2bfloat16_rn(v - __bfloat162float(h));
}

__device__ __forceinline__ void add_into(FragC& total, const FragC& part) {
#pragma unroll
  for (int e = 0; e < total.num_elements; ++e) total.x[e] += part.x[e];
}

template <bool FAST, bool SOFTMAX, int PASSES>
__global__ void __launch_bounds__(NT, 1)
mlp_bf16x3_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ dev,
                  const __nv_bfloat16* __restrict__ w1h,
                  const __nv_bfloat16* __restrict__ w1l,
                  const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2h,
                  const __nv_bfloat16* __restrict__ w2l,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int n_rows, int n_inp, int n_hid, int n_out, int kp, int hp,
                  int op) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(kp, op);
  const int xld = kp + 8;
  const int old = op + 4;
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xl = xh + (size_t)RT * xld;
  float* os = reinterpret_cast<float*>(smem);     // after the last chunk
  float* hs = reinterpret_cast<float*>(smem + lay.hs);
  __nv_bfloat16* hh = reinterpret_cast<__nv_bfloat16*>(smem + lay.hh);
  __nv_bfloat16* hl = reinterpret_cast<__nv_bfloat16*>(smem + lay.hl);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * RT;
  const int ot = op / 16;
  const int prow = warp % RTILES;             // phase-3 row tile of this warp

  // normalised, split x tile; zero past the last row and past n_inp
  for (int idx = tid; idx < RT * kp; idx += NT) {
    const int r = idx / kp;
    const int k = idx - r * kp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n_rows && k < n_inp) v = (x[row * n_inp + k] - mean[k]) * dev[k];
    split(v, xh + r * xld + k, xl + r * xld + k);
  }

  FragC acc[MAX_PPW];
#pragma unroll
  for (int i = 0; i < MAX_PPW; ++i) wmma::fill_fragment(acc[i], 0.0f);
  __syncthreads();

  for (int j0 = 0; j0 < hp; j0 += HC) {
    // 1. pre-activations of hidden units jc..jc+15, all row tiles
    const int jc = j0 + 16 * warp;
    FragC pre[RTILES];
#pragma unroll
    for (int r = 0; r < RTILES; ++r) wmma::fill_fragment(pre[r], 0.0f);
    for (int kg = 0; kg < kp; kg += KG) {
      FragC part[RTILES];
#pragma unroll
      for (int r = 0; r < RTILES; ++r) wmma::fill_fragment(part[r], 0.0f);
      const int kend = min(kg + KG, kp);
      for (int k = kg; k < kend; k += 16) {
        FragB bh, bl;
        wmma::load_matrix_sync(bh, w1h + (size_t)k * hp + jc, hp);
        if (PASSES == 3) wmma::load_matrix_sync(bl, w1l + (size_t)k * hp + jc, hp);
#pragma unroll
        for (int r = 0; r < RTILES; ++r) {
          FragA ah;
          wmma::load_matrix_sync(ah, xh + r * 16 * xld + k, xld);
          wmma::mma_sync(part[r], ah, bh, part[r]);
          if (PASSES == 3) {
            FragA al;
            wmma::load_matrix_sync(al, xl + r * 16 * xld + k, xld);
            wmma::mma_sync(part[r], ah, bl, part[r]);
            wmma::mma_sync(part[r], al, bh, part[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RTILES; ++r) add_into(pre[r], part[r]);
    }
#pragma unroll
    for (int r = 0; r < RTILES; ++r)
      wmma::store_matrix_sync(hs + r * 16 * HS_LD + 16 * warp, pre[r], HS_LD,
                              wmma::mem_row_major);
    __syncthreads();

    // 2. + b1, sigmoid, split h
    for (int idx = tid; idx < RT * HC; idx += NT) {
      const int r = idx / HC;
      const int j = idx - r * HC;
      const int jg = j0 + j;
      const float a = hs[r * HS_LD + j] + (jg < n_hid ? __ldg(b1 + jg) : 0.0f);
      split(sigmoid<FAST>(a), hh + r * HH_LD + j, hl + r * HH_LD + j);
    }
    __syncthreads();

    // 3. output tiles (row tile prow, column tiles warp / RTILES + 2 i)
    FragC part[MAX_PPW];
#pragma unroll
    for (int i = 0; i < MAX_PPW; ++i) wmma::fill_fragment(part[i], 0.0f);
#pragma unroll 2
    for (int kk = 0; kk < HC; kk += 16) {
      FragA ah, al;
      wmma::load_matrix_sync(ah, hh + prow * 16 * HH_LD + kk, HH_LD);
      if (PASSES == 3)
        wmma::load_matrix_sync(al, hl + prow * 16 * HH_LD + kk, HH_LD);
      const size_t wrow = (size_t)(j0 + kk) * op;
#pragma unroll
      for (int i = 0; i < MAX_PPW; ++i) {
        const int c = warp / RTILES + (NW / RTILES) * i;
        if (c < ot) {
          FragB bh;
          wmma::load_matrix_sync(bh, w2h + wrow + 16 * c, op);
          wmma::mma_sync(part[i], ah, bh, part[i]);
          if (PASSES == 3) {
            FragB bl;
            wmma::load_matrix_sync(bl, w2l + wrow + 16 * c, op);
            wmma::mma_sync(part[i], ah, bl, part[i]);
            wmma::mma_sync(part[i], al, bh, part[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_PPW; ++i) add_into(acc[i], part[i]);
    __syncthreads();       // hs, hh, hl are rewritten by the next chunk
  }

  // epilogue: the output tile into shared memory (over the x tile)
#pragma unroll
  for (int i = 0; i < MAX_PPW; ++i) {
    const int c = warp / RTILES + (NW / RTILES) * i;
    if (c < ot)
      wmma::store_matrix_sync(os + prow * 16 * old + 16 * c, acc[i], old,
                              wmma::mem_row_major);
  }
  __syncthreads();

  const int nq = (n_out + 31) / 32;
  for (int i = 0; i < RT / NW; ++i) {
    const int r = warp * (RT / NW) + i;
    const long long row = row0 + r;
    float v[MAX_NQ];
#pragma unroll
    for (int q = 0; q < MAX_NQ; ++q) {
      const int o = lane + 32 * q;
      v[q] = (q < nq && o < n_out) ? os[r * old + o] + __ldg(b2 + o) : 0.0f;
    }
    if (SOFTMAX) {
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q)
        if (q < nq && lane + 32 * q < n_out) mx = fmaxf(mx, v[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) {
        if (q < nq) {
          const float s = v[q] - mx;
          const float e = FAST ? fexp(s) : expf(s);
          v[q] = lane + 32 * q < n_out ? e : 0.0f;
          sum += v[q];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) v[q] = v[q] / sum;
    }
    if (row < n_rows) {
#pragma unroll
      for (int q = 0; q < MAX_NQ; ++q) {
        const int o = lane + 32 * q;
        if (q < nq && o < n_out) out[row * n_out + o] = v[q];
      }
    }
  }
}

template <bool FAST, bool SOFTMAX, int PASSES>
cudaError_t launch(const float* x, const float* mean, const float* dev,
                   const __nv_bfloat16* w1h, const __nv_bfloat16* w1l,
                   const float* b1, const __nv_bfloat16* w2h,
                   const __nv_bfloat16* w2l, const float* b2, float* out,
                   int n_rows, int n_inp, int n_hid, int n_out, int kp, int hp,
                   int op, cudaStream_t stream) {
  const size_t smem = layout(kp, op).total;
  auto kern = mlp_bf16x3_kernel<FAST, SOFTMAX, PASSES>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n_rows + RT - 1) / RT);
  kern<<<blocks, NT, smem, stream>>>(x, mean, dev, w1h, w1l, b1, w2h, w2l, b2,
                                     out, n_rows, n_inp, n_hid, n_out, kp, hp,
                                     op);
  return cudaGetLastError();
}

template <bool FAST, bool SOFTMAX>
cudaError_t dispatch_passes(int passes, const float* x, const float* mean,
                            const float* dev, const __nv_bfloat16* w1h,
                            const __nv_bfloat16* w1l, const float* b1,
                            const __nv_bfloat16* w2h, const __nv_bfloat16* w2l,
                            const float* b2, float* out, int n_rows, int n_inp,
                            int n_hid, int n_out, int kp, int hp, int op,
                            cudaStream_t s) {
  if (passes == 3)
    return launch<FAST, SOFTMAX, 3>(x, mean, dev, w1h, w1l, b1, w2h, w2l, b2,
                                    out, n_rows, n_inp, n_hid, n_out, kp, hp,
                                    op, s);
  return launch<FAST, SOFTMAX, 1>(x, mean, dev, w1h, w1l, b1, w2h, w2l, b2,
                                  out, n_rows, n_inp, n_hid, n_out, kp, hp, op,
                                  s);
}

}  // namespace

extern "C" int phn_mlp_bf16x3_max_out() { return 16 * MAX_OT; }
extern "C" int phn_mlp_bf16x3_max_inp() { return MAX_INP; }

// out[n_rows, n_out] = MLP(x[n_rows, n_inp]) with `passes` (1 or 3) bf16
// tensor-core passes per product.  x, mean, dev, b1, b2 float32 unpadded;
// w1h/w1l bf16 [kp, hp] and w2h/w2l bf16 [hp, op], zero-padded, with
// kp = round16(n_inp), hp = round128(n_hid), op = round16(n_out).  All
// contiguous on the current device.  Launches on `stream`, allocates
// nothing, does not synchronise.
extern "C" int phn_mlp_bf16x3(const void* x, const void* mean, const void* dev,
                              const void* w1h, const void* w1l, const void* b1,
                              const void* w2h, const void* w2l, const void* b2,
                              void* out, int n_rows, int n_inp, int n_hid,
                              int n_out, int fast, int softmax, int passes,
                              void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_inp > MAX_INP || n_hid <= 0 || n_out <= 0 ||
      n_out > 16 * MAX_OT || (passes != 1 && passes != 3))
    return cudaErrorInvalidValue;
  const int kp = (n_inp + 15) / 16 * 16;
  const int hp = (n_hid + HC - 1) / HC * HC;
  const int op = (n_out + 15) / 16 * 16;
  auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<const float*>(mean);
  auto* df = static_cast<const float*>(dev);
  auto* w1hb = static_cast<const __nv_bfloat16*>(w1h);
  auto* w1lb = static_cast<const __nv_bfloat16*>(w1l);
  auto* b1f = static_cast<const float*>(b1);
  auto* w2hb = static_cast<const __nv_bfloat16*>(w2h);
  auto* w2lb = static_cast<const __nv_bfloat16*>(w2l);
  auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (fast && softmax)
    return dispatch_passes<true, true>(passes, xf, mf, df, w1hb, w1lb, b1f,
                                       w2hb, w2lb, b2f, of, n_rows, n_inp,
                                       n_hid, n_out, kp, hp, op, s);
  if (fast)
    return dispatch_passes<true, false>(passes, xf, mf, df, w1hb, w1lb, b1f,
                                        w2hb, w2lb, b2f, of, n_rows, n_inp,
                                        n_hid, n_out, kp, hp, op, s);
  if (softmax)
    return dispatch_passes<false, true>(passes, xf, mf, df, w1hb, w1lb, b1f,
                                        w2hb, w2lb, b2f, of, n_rows, n_inp,
                                        n_hid, n_out, kp, hp, op, s);
  return dispatch_passes<false, false>(passes, xf, mf, df, w1hb, w1lb, b1f,
                                       w2hb, w2lb, b2f, of, n_rows, n_inp,
                                       n_hid, n_out, kp, hp, op, s);
}
