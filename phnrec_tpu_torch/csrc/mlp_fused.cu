// Fused 2-layer MLP forward, float32, for sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_mlp.py::mlp_forward_fused (the Pallas
// kernel `_kernel`, with `_fexp`, `_sigmoid` and `_finish`).
//
//   xn = (x - mean) * dev
//   h  = sigmoid(xn @ W1 + b1)        (ICSI fast exp when FAST)
//   o  = h @ W2 + b2
//   out = softmax(o) over the n_out columns (fast exp when FAST), or o
//
// What bounds it on the H100: at the CZ shapes (165->1500->138 twice,
// 276->1500->138) the two GEMMs are ~1.5M multiply-adds per row against
// ~1.2 KB of input and output per row, so the chain is compute-bound once the
// [N, n_hid] hidden activations stay on chip; unfused, that tensor is ~10x
// the size of the input and output together and makes the chain
// memory-bound.  Without tensor cores (float32 parity first) the ceiling is
// the FP32 FMA rate.
//
// Design: a block of 256 threads owns a tile of 32 rows.  It normalises its
// x tile once into shared memory (transposed, [k][row]), then walks the
// hidden axis in chunks of 64: each thread computes an 8-row x 1-unit strip
// of the chunk's pre-activations with FMAs (one W1 load feeds 8 FMAs; the
// x values are float4 broadcasts), applies the sigmoid and stores the chunk
// to shared memory; then each warp accumulates h_chunk @ W2[chunk, :] for
// its 4 rows into registers (lane = output column, NQ columns per lane).
// The hidden tensor never reaches device memory.  The epilogue adds b2 and
// takes the row softmax with warp shuffles.  No tensor cores, no TMA: those
// come with a reduced-precision mode.
//
// fexp follows phnrec_tpu/posteriors/fexp.py bit for bit: one float32
// multiply by the float32-rounded constant, a saturating truncation
// (__float2int_rz), a wrapping int32 add, and an exact 2^e that is 0 for
// e <= -126 (XLA on the CPU flushes there).  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 32;          // rows per block
constexpr int HC = 64;          // hidden units per chunk
constexpr int NT = 256;         // threads per block
constexpr int XS = RT + 4;      // shared row stride: float4-aligned, fewer conflicts
constexpr int MAX_NQ = 8;       // n_out <= 32 * MAX_NQ

constexpr float FEXP_A = 1512775.395195186f;   // 2^20 / ln 2, rounded to f32
constexpr unsigned FEXP_K = 1072693248u - 60801u;

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

template <bool FAST, bool SOFTMAX, int NQ>
__global__ void __launch_bounds__(NT)
mlp_fused_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ dev, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out,
                 int n_rows, int n_inp, int n_hid, int n_out) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [n_inp][XS]
  float* hs = xs + (size_t)n_inp * XS;           // [HC][XS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * RT;

  // normalised x tile, zero past the last row
  for (int idx = tid; idx < RT * n_inp; idx += NT) {
    const int r = idx / n_inp;
    const int k = idx - r * n_inp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < n_rows) v = (x[row * n_inp + k] - mean[k]) * dev[k];
    xs[k * XS + r] = v;
  }

  // phase-1 strip: hidden unit hj of the chunk, rows hr..hr+7
  const int hj = tid % HC;
  const int hr = (tid / HC) * 8;
  // phase-2 strip: rows orow..orow+3, columns lane + 32*q
  const int orow = warp * 4;

  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;

  __syncthreads();

  for (int j0 = 0; j0 < n_hid; j0 += HC) {
    const int j = j0 + hj;
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = 0.0f;
    if (j < n_hid) {
      const float* wp = w1 + j;
#pragma unroll 4
      for (int k = 0; k < n_inp; ++k) {
        const float w = __ldg(wp + (size_t)k * n_hid);
        const float4 xa = *reinterpret_cast<const float4*>(xs + k * XS + hr);
        const float4 xb =
            *reinterpret_cast<const float4*>(xs + k * XS + hr + 4);
        a[0] = fmaf(xa.x, w, a[0]);
        a[1] = fmaf(xa.y, w, a[1]);
        a[2] = fmaf(xa.z, w, a[2]);
        a[3] = fmaf(xa.w, w, a[3]);
        a[4] = fmaf(xb.x, w, a[4]);
        a[5] = fmaf(xb.y, w, a[5]);
        a[6] = fmaf(xb.z, w, a[6]);
        a[7] = fmaf(xb.w, w, a[7]);
      }
      const float bj = __ldg(b1 + j);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sigmoid<FAST>(a[i] + bj);
    }
    *reinterpret_cast<float4*>(hs + hj * XS + hr) =
        make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(hs + hj * XS + hr + 4) =
        make_float4(a[4], a[5], a[6], a[7]);
    __syncthreads();

    const int jn = min(HC, n_hid - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const float4 h = *reinterpret_cast<const float4*>(hs + jj * XS + orow);
      const float* w2p = w2 + (size_t)(j0 + jj) * n_out;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int o = lane + 32 * q;
        const float w = o < n_out ? __ldg(w2p + o) : 0.0f;
        acc[q][0] = fmaf(h.x, w, acc[q][0]);
        acc[q][1] = fmaf(h.y, w, acc[q][1]);
        acc[q][2] = fmaf(h.z, w, acc[q][2]);
        acc[q][3] = fmaf(h.w, w, acc[q][3]);
      }
    }
    __syncthreads();
  }

  float bias[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int o = lane + 32 * q;
    bias[q] = o < n_out ? __ldg(b2 + o) : 0.0f;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + orow + i;
    float v[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[q] = acc[q][i] + bias[q];
    if (SOFTMAX) {
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
        const float e = FAST ? fexp(s) : expf(s);
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

template <bool FAST, bool SOFTMAX, int NQ>
cudaError_t launch(const float* x, const float* mean, const float* dev,
                   const float* w1, const float* b1, const float* w2,
                   const float* b2, float* out, int n_rows, int n_inp,
                   int n_hid, int n_out, cudaStream_t stream) {
  const size_t smem = (size_t)(n_inp + HC) * XS * sizeof(float);
  auto kern = mlp_fused_kernel<FAST, SOFTMAX, NQ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n_rows + RT - 1) / RT);
  kern<<<blocks, NT, smem, stream>>>(x, mean, dev, w1, b1, w2, b2, out,
                                     n_rows, n_inp, n_hid, n_out);
  return cudaGetLastError();
}

template <bool FAST, bool SOFTMAX>
cudaError_t dispatch_nq(int nq, const float* x, const float* mean,
                        const float* dev, const float* w1, const float* b1,
                        const float* w2, const float* b2, float* out,
                        int n_rows, int n_inp, int n_hid, int n_out,
                        cudaStream_t s) {
#define PHN_NQ_CASE(N)                                                      \
  case N:                                                                   \
    return launch<FAST, SOFTMAX, N>(x, mean, dev, w1, b1, w2, b2, out,     \
                                    n_rows, n_inp, n_hid, n_out, s);
  switch (nq) {
    PHN_NQ_CASE(1) PHN_NQ_CASE(2) PHN_NQ_CASE(3) PHN_NQ_CASE(4)
    PHN_NQ_CASE(5) PHN_NQ_CASE(6) PHN_NQ_CASE(7) PHN_NQ_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PHN_NQ_CASE
}

}  // namespace

extern "C" int phn_mlp_fused_max_out() { return 32 * MAX_NQ; }

// out[n_rows, n_out] = MLP(x[n_rows, n_inp]); w1 is [n_inp, n_hid], w2 is
// [n_hid, n_out], all float32, contiguous, on the current device.  Launches
// on `stream`, allocates nothing, does not synchronise.
extern "C" int phn_mlp_fused(const void* x, const void* mean, const void* dev,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int n_rows, int n_inp,
                             int n_hid, int n_out, int fast, int softmax,
                             void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  if (n_inp <= 0 || n_hid <= 0 || n_out <= 0 || n_out > 32 * MAX_NQ)
    return cudaErrorInvalidValue;
  const int nq = (n_out + 31) / 32;
  auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<const float*>(mean);
  auto* df = static_cast<const float*>(dev);
  auto* w1f = static_cast<const float*>(w1);
  auto* b1f = static_cast<const float*>(b1);
  auto* w2f = static_cast<const float*>(w2);
  auto* b2f = static_cast<const float*>(b2);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (fast && softmax)
    return dispatch_nq<true, true>(nq, xf, mf, df, w1f, b1f, w2f, b2f, of,
                                   n_rows, n_inp, n_hid, n_out, s);
  if (fast)
    return dispatch_nq<true, false>(nq, xf, mf, df, w1f, b1f, w2f, b2f, of,
                                    n_rows, n_inp, n_hid, n_out, s);
  if (softmax)
    return dispatch_nq<false, true>(nq, xf, mf, df, w1f, b1f, w2f, b2f, of,
                                    n_rows, n_inp, n_hid, n_out, s);
  return dispatch_nq<false, false>(nq, xf, mf, df, w1f, b1f, w2f, b2f, of,
                                   n_rows, n_inp, n_hid, n_out, s);
}
