// Frame scans of HMM training, for sm_90a: kernel J (the phoneme-loop
// forward-backward), kernel K (the dense training-graph forward-backward)
// and kernel K' (the training graph's Viterbi alignment and traceback).
//
// Replaces (XLA lax.scans; none has a Pallas twin):
// * J: phnrec_tpu/decoder/forward_backward.py::forward_backward (forward
//   scan :78, backward scan :104): log-domain alpha and beta over a loop of
//   P phonemes x S states, logaddexp in place of the Viterbi max, the entry
//   lse over the P exit states (+ w_penalty) a frame forwards, the
//   re-entry lse over the P first states a frame backwards.
// * K: phnrec_tpu/train/fb.py::forward_backward (scans :111 and :123): per
//   frame the lse over i of alpha[i] + log_A[i, j] (forwards) and of
//   log_A[i, j] + (log_b[t+1, j] + beta[j]) (backwards), the dense [S, S]
//   form JAX computes; frames at t >= n_frames keep the carry and emit
//   NEG_INF (-1e30) rows.
// * K': phnrec_tpu/train/fb.py::viterbi_align (scans :153 and :168): the
//   max-plus forward with back-pointers (ties keep the smaller source, as
//   jnp.argmax does), the final argmax and the walk back, in one kernel.
//
// Each lse follows jax.scipy.special.logsumexp: the max m of the terms (0
// where it is not finite), then log(sum exp(x - m)) + m; logaddexp is
// jnp.logaddexp's m + log1p(exp(-|a - b|)).  J and K sum their exps in
// another order than XLA and torch do, so they are held to a tolerance;
// K' is adds and compares only, bit-equal to its plain version.
//
// What bounds them on the H100: the frame loop is a chain of T dependent
// steps with a block barrier each, and K's [S, S] lse costs S^2 exps a
// frame (S 256: 65,536 a frame, two passes over log_A each).  Neither
// is near the card's bytes or operations: the bound is the chain of
// dependent steps on one SM per utterance.
//
// Design: one block per utterance (a bucket's B utterances in parallel),
// the frame loop inside the kernel.
// * J: a thread per (p, s) (P*S <= 1,024 threads; more take a strided
//   loop), alpha / beta of the current frame in shared memory for the
//   neighbour state, the two per-frame lses as block reductions (warp
//   shuffles, then one word a warp in shared memory).
// * K / K': four lanes of a warp per destination state j (lane q takes the
//   sources i = q mod 4, combined by shuffles), 1,024 threads for S >=
//   256, columns strided past the block's threads.  (A thread per column,
//   256 threads at S 256, waited on its chains of log_A loads from L2:
//   3.3x slower, PERF.md.)  The carry (alpha, or beta and b + beta) lives
//   in shared memory while 2 S floats fit in 48 KB (S <= 6,000), else in
//   a device scratch the wrapper allocates (the looped path: same code,
//   slower loads).  log_A is read through L1/L2 (S 256: 256 KB an
//   utterance, more than shared memory holds): forwards the lanes of
//   column j read its rows; backwards the wrapper passes log_A
//   transposed, so the lanes of state i read row i of the transpose.
// * K' writes its back-pointers [T, S] (int32) to device memory; after the
//   forward loop the block takes the final argmax by a (value, index)
//   reduction and thread 0 walks the back-pointers from t = n - 1 down.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr float NEG_INF_TRAIN = -1e30f;   // train/fb.py's NEG_INF
constexpr int MAX_THREADS = 1024;         // K / K' threads a block
constexpr int Q = 4;                      // K / K' lanes a column
constexpr size_t SMEM_LIMIT = 48 * 1024;  // carries in shared memory up to

__device__ __forceinline__ float lae(float a, float b) {
  // jnp.logaddexp: infinities of one sign give that infinity
  if (isinf(a) && a == b) return a;
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Reduce v over the block (blockDim a multiple of 32); every thread gets
// the result.  red holds 32 floats.
template <class Op>
__device__ float block_reduce(float v, float* red, Op op, float ident) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();
  if (l == 0) red[w] = v;
  __syncthreads();
  v = l < nw ? red[l] : ident;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// jax.scipy.special.logsumexp over p of x[p * S + which] + add (x complete
// in memory before the call); every thread gets the result.
__device__ float lse_states(const float* x, int P, int S, int which, float add,
                            float* red) {
  float m = -INFINITY;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    m = fmaxf(m, x[p * S + which] + add);
  m = block_reduce(m, red, MaxOp(), -INFINITY);
  if (!isfinite(m)) m = 0.0f;
  float s = 0.0f;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    s += expf(x[p * S + which] + add - m);
  s = block_reduce(s, red, SumOp(), 0.0f);
  return logf(s) + m;
}

// ---------------------------------------------------------------- kernel J
// lp [B, T, D] (columns p*S + s), alpha / beta [B, T, P*S], like [B].
// buf: 2 * P*S floats (shared or scratch), red: 32 floats of shared.
__global__ void phnloop_fb_kernel(const float* __restrict__ lp, int T, int D,
                                  int P, int S, float w_pen, float tr_c,
                                  float tr_n, float* __restrict__ alpha,
                                  float* __restrict__ beta,
                                  float* __restrict__ like,
                                  float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int PS = P * S;
  const int b = blockIdx.x;
  float* red = smem;
  float* buf = scratch ? scratch + (size_t)b * 2 * PS : smem + 32;
  const float* obs = lp + (size_t)b * T * D;
  float* al = alpha + (size_t)b * T * PS;
  float* be = beta + (size_t)b * T * PS;
  const float NEG = -FLT_MAX;   // the phoneme loop's NEG_INF

  // forwards: buf[c] holds alpha_{t-1}, buf[1 - c] takes alpha_t
  for (int k = threadIdx.x; k < PS; k += blockDim.x) buf[k] = NEG;
  float entry = w_pen;   // the reference quirk: w_penalty at t = 0
  int c = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = buf + c * PS;
    float* nxt = buf + (1 - c) * PS;
    for (int k = threadIdx.x; k < PS; k += blockDim.x) {
      const int s = k % S;
      const float stay = cur[k] + tr_c;
      const float adv = s > 0 ? cur[k - 1] + tr_n : NEG;
      const float inc = s == 0 ? entry : NEG;
      const float v = lae(lae(stay, adv), inc) + obs[(size_t)t * D + k];
      nxt[k] = v;
      al[(size_t)t * PS + k] = v;
    }
    __syncthreads();
    // the loop node: lse over the exit states + tr_n, then the penalty
    // (its barriers also keep cur until every thread has read it)
    entry = lse_states(nxt, P, S, S - 1, tr_n, red) + w_pen;
    c = 1 - c;
  }
  // log_like: lse over the exit states of alpha_T
  const float ll = lse_states(buf + c * PS, P, S, S - 1, 0.0f, red);
  if (threadIdx.x == 0) like[b] = ll;
  __syncthreads();

  // backwards: buf[0] holds beta_t, buf[1] takes beta_t + obs_t
  float* bt = buf;
  float* bo = buf + PS;
  for (int k = threadIdx.x; k < PS; k += blockDim.x)
    bt[k] = k % S == S - 1 ? 0.0f : NEG;
  for (int t = T - 1; t >= 0; --t) {
    for (int k = threadIdx.x; k < PS; k += blockDim.x) {
      be[(size_t)t * PS + k] = bt[k];
      bo[k] = bt[k] + obs[(size_t)t * D + k];
    }
    __syncthreads();
    // re-entry: lse over the P first states of beta_t + obs_t
    const float reentry = lse_states(bo, P, S, 0, 0.0f, red) + w_pen;
    for (int k = threadIdx.x; k < PS; k += blockDim.x) {
      const int s = k % S;
      const float stay = bo[k] + tr_c;
      const float adv = s < S - 1 ? bo[k + 1] + tr_n : NEG;
      const float ext = s == S - 1 ? tr_n + reentry : NEG;
      bt[k] = lae(lae(stay, adv), ext);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernel K
// Q lanes of a warp share a destination column: lane q takes the sources
// i = q, q + Q, ... (neighbouring lanes on neighbouring words of the
// carry, no bank conflicts), and the lanes' maxima and sums combine by
// shuffles.  Every lane of the block walks the same column loop (columns
// past S compute nothing), so the shuffles always find all 32 lanes.

// lse over i of x(i) for one column (the lanes' share of the sources, then
// the butterfly over the Q lanes); ``live`` false gives 0.
template <class X>
__device__ __forceinline__ float column_lse(int S, int q, bool live, X x) {
  float m = -INFINITY;
  if (live) {
#pragma unroll 4
    for (int i = q; i < S; i += Q) m = fmaxf(m, x(i));
  }
  for (int o = 1; o < Q; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float mm = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  if (live) {
#pragma unroll 4
    for (int i = q; i < S; i += Q) s += expf(x(i) - mm);
  }
  for (int o = 1; o < Q; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return logf(s) + mm;
}

// log_A / log_AT [B, S, S] (log_AT[b, j, i] = log_A[b, i, j]), entry / exit
// [B, S], log_b [B, T, S], n [B]; alpha / beta [B, T, S], like [B].
// buf: 2 * S floats (shared or scratch).
__global__ void graph_fb_kernel(const float* __restrict__ log_A,
                                const float* __restrict__ log_AT,
                                const float* __restrict__ log_entry,
                                const float* __restrict__ log_exit,
                                const float* __restrict__ log_b,
                                const int* __restrict__ n_frames, int T, int S,
                                float* __restrict__ alpha,
                                float* __restrict__ beta,
                                float* __restrict__ like,
                                float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* red = smem;
  float* buf = scratch ? scratch + (size_t)b * 2 * S : smem + 32;
  const float* A = log_A + (size_t)b * S * S;
  const float* AT = log_AT + (size_t)b * S * S;
  const float* en = log_entry + (size_t)b * S;
  const float* ex = log_exit + (size_t)b * S;
  const float* lb = log_b + (size_t)b * T * S;
  float* al = alpha + (size_t)b * T * S;
  float* be = beta + (size_t)b * T * S;
  const int n = n_frames[b];
  const int q = threadIdx.x % Q, c0 = threadIdx.x / Q;
  const int ncol = blockDim.x / Q;

  // forwards: ping-pong between buf[0:S] and buf[S:2S]
  for (int j = threadIdx.x; j < S; j += blockDim.x) buf[j] = NEG_INF_TRAIN;
  int c = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = buf + c * S;
    float* nxt = buf + (1 - c) * S;
    const bool prop = t > 0 && t < n;
    for (int j0 = 0; j0 < S; j0 += ncol) {
      const int j = j0 + c0;
      const bool ok = j < S;
      const float p = column_lse(S, q, prop && ok, [&](int i) {
        return cur[i] + A[(size_t)i * S + j];
      });
      if (ok && q == 0) {
        float out = NEG_INF_TRAIN, keep = cur[j];
        if (t < n) keep = out = (t == 0 ? en[j] : p) + lb[(size_t)t * S + j];
        nxt[j] = keep;
        al[(size_t)t * S + j] = out;
      }
    }
    __syncthreads();
    c = 1 - c;
  }
  // log_like = lse_j(alpha_last[j] + exit[j])
  {
    const float* cur = buf + c * S;
    float m = -INFINITY;
    for (int j = threadIdx.x; j < S; j += blockDim.x) m = fmaxf(m, cur[j] + ex[j]);
    m = block_reduce(m, red, MaxOp(), -INFINITY);
    if (!isfinite(m)) m = 0.0f;
    float s = 0.0f;
    for (int j = threadIdx.x; j < S; j += blockDim.x) s += expf(cur[j] + ex[j] - m);
    s = block_reduce(s, red, SumOp(), 0.0f);
    if (threadIdx.x == 0) like[b] = logf(s) + m;
  }
  __syncthreads();

  // backwards: bt = beta_{t+1} (carry), v = log_b[t+1] + beta_{t+1}
  float* bt = buf;
  float* v = buf + S;
  for (int j = threadIdx.x; j < S; j += blockDim.x) bt[j] = NEG_INF_TRAIN;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const int tn = t + 1 < T ? t + 1 : T - 1;   // JAX's b_shift
    const bool prop = t < n - 1;
    if (prop) {
      for (int j = threadIdx.x; j < S; j += blockDim.x)
        v[j] = lb[(size_t)tn * S + j] + bt[j];
      __syncthreads();
    }
    for (int i0 = 0; i0 < S; i0 += ncol) {
      const int i = i0 + c0;
      const bool ok = i < S;
      const float p = column_lse(S, q, prop && ok, [&](int j) {
        return AT[(size_t)j * S + i] + v[j];
      });
      if (ok && q == 0) {
        const float nw = t == n - 1 ? ex[i] : (prop ? p : bt[i]);
        bt[i] = nw;
        be[(size_t)t * S + i] = t < n ? nw : NEG_INF_TRAIN;
      }
    }
    __syncthreads();   // bt and v are read again next frame
  }
}

// --------------------------------------------------------------- kernel K'
// As K's inputs (no log_AT); bps [B, T, S] int32 (device scratch the
// wrapper allocates), states [B, T] int32, like [B].  Lanes as K's; each
// lane keeps the first max of its sources, and the butterfly keeps the
// larger value, on ties the smaller source: the first max overall.
__global__ void graph_align_kernel(const float* __restrict__ log_A,
                                   const float* __restrict__ log_entry,
                                   const float* __restrict__ log_exit,
                                   const float* __restrict__ log_b,
                                   const int* __restrict__ n_frames, int T,
                                   int S, int* __restrict__ bps,
                                   int* __restrict__ states,
                                   float* __restrict__ like,
                                   float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ int red_i[32];
  const int b = blockIdx.x;
  float* red = smem;
  float* buf = scratch ? scratch + (size_t)b * 2 * S : smem + 32;
  const float* A = log_A + (size_t)b * S * S;
  const float* en = log_entry + (size_t)b * S;
  const float* ex = log_exit + (size_t)b * S;
  const float* lb = log_b + (size_t)b * T * S;
  int* bp = bps + (size_t)b * T * S;
  const int n = n_frames[b];
  const int q = threadIdx.x % Q, c0 = threadIdx.x / Q;
  const int ncol = blockDim.x / Q;

  for (int j = threadIdx.x; j < S; j += blockDim.x) buf[j] = NEG_INF_TRAIN;
  int c = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* cur = buf + c * S;
    float* nxt = buf + (1 - c) * S;
    const bool live = t < n;
    for (int j0 = 0; j0 < S; j0 += ncol) {
      const int j = j0 + c0;
      const bool ok = j < S;
      float best = -INFINITY;
      int arg = 0x7fffffff;
      if (live && ok && q < S) {
        best = cur[q] + A[(size_t)q * S + j];
        arg = q;
#pragma unroll 4
        for (int i = q + Q; i < S; i += Q) {
          const float x = cur[i] + A[(size_t)i * S + j];
          if (x > best) best = x, arg = i;   // the first max of the lane
        }
      }
      for (int o = 1; o < Q; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ov > best || (ov == best && oi < arg)) best = ov, arg = oi;
      }
      if (ok && q == 0) {
        nxt[j] = live ? (t == 0 ? en[j] : best) + lb[(size_t)t * S + j]
                      : cur[j];
        bp[(size_t)t * S + j] = live ? arg : 0;
      }
    }
    __syncthreads();
    c = 1 - c;
  }

  // final argmax of alpha_last + exit: the larger value, on ties the
  // smaller index (threads without a state hold (-inf, INT_MAX))
  const float* cur = buf + c * S;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float x = cur[j] + ex[j];
    if (x > bv || (x == bv && j < bi)) bv = x, bi = j;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) red[w] = bv, red_i[w] = bi;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v0 = red[0];
    int i0 = red_i[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      const float ov = red[k];
      const int oi = red_i[k];
      if (ov > v0 || (ov == v0 && oi < i0)) v0 = ov, i0 = oi;
    }
    like[b] = v0;
    // the walk back (train/fb.py:160-168)
    int carry = i0;
    int* st = states + (size_t)b * T;
    for (int t = T - 1; t >= 0; --t) {
      const int cu = t == n - 1 ? i0 : carry;
      st[t] = t < n ? cu : -1;
      carry = t <= n - 1 ? bp[(size_t)t * S + cu] : cu;
    }
  }
}

int threads_for(int width, int cap) {
  int t = (width + 31) / 32 * 32;
  return t < 32 ? 32 : (t > cap ? cap : t);
}

}  // namespace

// Bytes of device scratch a launch needs for B utterances of width W (P*S
// for J, S for K / K'): 0 where the carries fit in shared memory.
extern "C" long long trainfb_scratch_floats(int B, int W) {
  const size_t smem = (size_t)(32 + 2 * (size_t)W) * sizeof(float);
  return smem <= SMEM_LIMIT ? 0 : (long long)B * 2 * W;
}

extern "C" int phn_loop_fb(const void* lp, int B, int T, int D, int P, int S,
                           float w_pen, float tr_c, float tr_n, void* alpha,
                           void* beta, void* like, void* scratch,
                           void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (P <= 0 || S <= 0 || D < P * S) return cudaErrorInvalidValue;
  const int PS = P * S;
  const int threads = threads_for(PS, 1024);
  const size_t smem = scratch ? 32 * sizeof(float)
                              : (32 + 2 * (size_t)PS) * sizeof(float);
  phnloop_fb_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), T, D, P, S, w_pen, tr_c, tr_n,
      static_cast<float*>(alpha), static_cast<float*>(beta),
      static_cast<float*>(like), static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" int graph_fb(const void* log_A, const void* log_AT,
                        const void* log_entry, const void* log_exit,
                        const void* log_b, const void* n_frames, int B, int T,
                        int S, void* alpha, void* beta, void* like,
                        void* scratch, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (S <= 0) return cudaErrorInvalidValue;
  const int threads = threads_for(Q * S, MAX_THREADS);
  const size_t smem = scratch ? 32 * sizeof(float)
                              : (32 + 2 * (size_t)S) * sizeof(float);
  graph_fb_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_A), static_cast<const float*>(log_AT),
      static_cast<const float*>(log_entry), static_cast<const float*>(log_exit),
      static_cast<const float*>(log_b), static_cast<const int*>(n_frames), T, S,
      static_cast<float*>(alpha), static_cast<float*>(beta),
      static_cast<float*>(like), static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" int graph_align(const void* log_A, const void* log_entry,
                           const void* log_exit, const void* log_b,
                           const void* n_frames, int B, int T, int S,
                           void* bps, void* states, void* like, void* scratch,
                           void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (S <= 0) return cudaErrorInvalidValue;
  const int threads = threads_for(Q * S, MAX_THREADS);
  const size_t smem = scratch ? 32 * sizeof(float)
                              : (32 + 2 * (size_t)S) * sizeof(float);
  graph_align_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_A), static_cast<const float*>(log_entry),
      static_cast<const float*>(log_exit), static_cast<const float*>(log_b),
      static_cast<const int*>(n_frames), T, S, static_cast<int*>(bps),
      static_cast<int*>(states), static_cast<float*>(like),
      static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}
