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
// steps with a barrier each, and K's [S, S] lse costs S^2 exps a frame (S
// 256: 65,536 a frame, two passes over log_A each).  Neither is near the
// card's bytes or operations: the bound is the chain of dependent steps
// and what one step costs.
//
// Two designs of K and K'; the wrapper's plan (ops/trainfb.py) takes the
// cluster kernels where log_A's slices fit a cluster's shared memory (S
// up to 928 at 16 blocks), the one-block kernels past it.  On one block
// an utterance a step waited on chains of log_A loads from L2 (12.96 us
// a step at S 256, one SM an utterance); on a cluster of c blocks log_A
// stays in shared memory and the carries move block to block (1.3-1.7 us
// a step, PERF.md).
//
// Design of J and the one-block kernels: one block per utterance (a
// bucket's B utterances in parallel), the frame loop inside the kernel.
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

// ------------------------------------------------ K and K' on a cluster
// One thread-block cluster of c blocks (c from 2 to 8, or 16) an utterance,
// one block an SM.  Block r owns the states [r W, (r + 1) W), W = ceil(S /
// c): forwards (and in K') the columns j of log_A, backwards the rows i.
// Its slice of log_A lives in shared memory for the whole scan; the QC
// lanes of a column each keep their sources (i = q mod QC) side by side
// and read them as float4s.  Each block keeps the whole carry (alpha, or
// log_b[t + 1] + beta backwards) in two buffers: after a frame's lse (and
// a block barrier: every warp has read the buffer the peers refill next)
// its lanes store their states' next values into every block's other
// buffer with st.async, each store counted on that block's mbarrier of
// the buffer; a frame begins by waiting on its own mbarrier for all S
// values.  No cluster-wide barrier in the frame loop: its release fence
// (MEMBAR.GPU, then an L1 invalidation) cost ~0.66 us a frame.  Each
// column's arithmetic is graph_fb_kernel's / graph_align_kernel's (the
// same terms, expf and logf, the same maximum) but for QC; frames t >= n
// keep the carry and need neither lse nor exchange.

__host__ __device__ inline int threads_for(int width, int cap) {
  int t = (width + 31) / 32 * 32;
  return t < 32 ? 32 : (t > cap ? cap : t);
}

// Lanes a column in the cluster kernels: eight, twice graph_fb_kernel's
// four, halve each lane's chain of terms (K's sums are then associated
// otherwise: held to the tolerance; K' keeps the first maximum in any
// split).  A block's columns times QC threads stay within 1,024.
constexpr int QC = 8;

// The slice's width, and the pitch L of a lane's sources: lane q of a
// column keeps its sources i = q, q + QC, ... at [q L, q L + S/QC); a
// column takes QC L floats.  L = ceil(S / QC) rounded up to 4 mod 8 puts
// the eight lanes of a quarter warp on eight different 16-byte bank
// groups.  The carries keep the same order (state i at perm(i)).  The
// dynamic shared memory of a cluster block: the slice, two carries, 64
// words for reductions and two mbarriers.
__host__ __device__ inline int slice_cols(int S, int c) { return (S + c - 1) / c; }
__host__ __device__ inline int lane_pitch(int S) {
  const int sq = (S + QC - 1) / QC;
  return sq + ((4 - sq) % 8 + 8) % 8;
}
__host__ __device__ inline int perm(int i, int L) { return (i % QC) * L + i / QC; }
inline size_t cluster_smem(int S, int c) {
  const size_t C = (size_t)QC * lane_pitch(S);
  return 4 * ((size_t)slice_cols(S, c) * C + 2 * C + 72);
}
constexpr size_t CLUSTER_SMEM_MAX = 232448;    // a block's shared memory
constexpr size_t ONE_BLOCK_AN_SM = 116 * 1024;  // over half an SM's 228 KB
// a cluster size the kernels take at S states: 2 to 8 blocks (portable)
// or 16 (non-portable), the slice within a block's shared memory and its
// columns' lanes within 1,024 threads
inline bool cluster_fits(int S, int c) {
  return S > 0 && ((c >= 2 && c <= 8) || c == 16) &&
         cluster_smem(S, c) <= CLUSTER_SMEM_MAX &&
         QC * slice_cols(S, c) <= MAX_THREADS;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
// every thread of the cluster; this block's and its peers' stores before
// it are visible to every thread after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

typedef unsigned long long mbar_t;
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the shared::cluster address of block ``rank``'s copy of a shared word
__device__ __forceinline__ unsigned peer_u32(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void mbar_init(mbar_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(b))
               : "memory");
}
// the phase's one arrival, and the bytes the peers' stores bring
__device__ __forceinline__ void mbar_arm(mbar_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}
// wait for the phase of mbarrier k (of two) whose parity ``ph`` keeps
__device__ __forceinline__ void mbar_wait(mbar_t* b, unsigned& ph, int k) {
  unsigned done;
  const unsigned parity = (ph >> k) & 1u;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  } while (!done);
  ph ^= 1u << k;
}
// v into every block's copy of p, counted on that block's copy of b; the
// QC lanes of a column share the peers
__device__ __forceinline__ void push_all(const float* p, mbar_t* b,
                                         unsigned nc, int q, float v) {
  const unsigned lp = smem_u32(p), lbar = smem_u32(b);
  for (unsigned r = q; r < nc; r += QC)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
        :: "r"(peer_u32(lp, r)), "r"(__float_as_uint(v)), "r"(peer_u32(lbar, r))
        : "memory");
}

// column_lse over a lane's sources held as perm() orders them: a (the
// lane's row of the slice) + v (the lane's row of the carry), K4 chunks
// of four; the pad entries (a -inf, v 0) add nothing.  The same terms,
// the same maximum (exact in any order), each lane's sum in ascending
// order, then the butterfly over the QC lanes.
__device__ __forceinline__ float column_lse4(int K4, bool live, const float* a,
                                             const float* v) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  if (live) {
#pragma unroll 4
    for (int k = 0; k < K4; ++k) {
      const float4 x = a4[k], y = v4[k];
      m0 = fmaxf(m0, x.x + y.x);
      m1 = fmaxf(m1, x.y + y.y);
      m2 = fmaxf(m2, x.z + y.z);
      m3 = fmaxf(m3, x.w + y.w);
    }
  }
  float m = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
  for (int o = 1; o < QC; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float mm = isfinite(m) ? m : 0.0f;
  float s = 0.0f;
  if (live) {
#pragma unroll 4
    for (int k = 0; k < K4; ++k) {
      const float4 x = a4[k], y = v4[k];
      s += expf(x.x + y.x - mm);
      s += expf(x.y + y.y - mm);
      s += expf(x.z + y.z - mm);
      s += expf(x.w + y.w - mm);
    }
  }
  for (int o = 1; o < QC; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return logf(s) + mm;
}

// lse over j of cur[perm(j)] + ex[j] exactly as graph_fb_kernel's block
// of threads_for(Q * S, MAX_THREADS) threads sums it (its strided sums,
// its warps' butterflies, then the butterfly over the warps' sums),
// whatever this block's size: bit-equal.  red holds 64 floats.
__device__ float like_lse(const float* cur, const float* ex, int S, int L,
                         float* red) {
  const int bd = threads_for(Q * S, MAX_THREADS), nw = bd >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = -INFINITY;
  for (int j = threadIdx.x; j < S; j += blockDim.x)
    m = fmaxf(m, cur[perm(j, L)] + ex[j]);
  m = block_reduce(m, red, MaxOp(), -INFINITY);
  if (!isfinite(m)) m = 0.0f;
  for (int w = warp; w < nw; w += blockDim.x >> 5) {
    float s = 0.0f;
    for (int j = w * 32 + lane; j < S; j += bd)
      s += expf(cur[perm(j, L)] + ex[j] - m);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[32 + w] = s;
  }
  __syncthreads();
  float v = lane < nw ? red[32 + lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return logf(v) + m;
}

// This block's place in the cluster, its slice and its shared memory.
struct Slice {
  unsigned nc;     // blocks of the cluster
  int b;           // the utterance
  int j0, nown;    // the first state this block owns, and how many
  int L, C, K4;    // a lane's pitch, a column's floats, a lane's chunks
  int q, jl, j;    // this lane: its lane of the column, column, state
  bool ok;         // the lane has a state
  float* As;       // the slice
  float* buf;      // the two carries
  float* red;      // 64 words
  mbar_t* mb;      // the carries' mbarriers
};

__device__ __forceinline__ Slice slice_of(int S, float* smem) {
  Slice s;
  s.nc = cluster_blocks();
  s.b = (int)cluster_index();
  const int W = slice_cols(S, (int)s.nc);
  s.j0 = (int)cluster_rank() * W;
  s.nown = max(0, min(W, S - s.j0));
  s.L = lane_pitch(S);
  s.C = QC * s.L;
  s.K4 = ((S + QC - 1) / QC + 3) / 4;
  s.q = threadIdx.x % QC;
  s.jl = threadIdx.x / QC;
  s.j = s.j0 + s.jl;
  s.ok = s.jl < s.nown;
  s.As = smem;
  s.buf = smem + (size_t)W * s.C;
  s.red = s.buf + 2 * s.C;
  s.mb = reinterpret_cast<mbar_t*>(s.red + 64);
  return s;
}

// The mbarriers, the carries (the states NEG_INF, the pad entries 0) and
// the column slice: As[l][perm(i)] = A[i][j0 + l] (rows: A[j0 + l][i]),
// the pad entries -inf.  Ends with the block's barrier.
__device__ void init_block(const Slice& s, int S) {
  if (threadIdx.x == 0) {
    mbar_init(s.mb);
    mbar_init(s.mb + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int k = threadIdx.x; k < 2 * s.C; k += blockDim.x) {
    const int r = k % s.C, i = r / s.L + QC * (r % s.L);
    s.buf[k] = i < S ? NEG_INF_TRAIN : 0.0f;
  }
}
__device__ void load_slice(const Slice& s, const float* A, int S, bool rows) {
  for (int k = threadIdx.x; k < s.C * s.nown; k += blockDim.x) s.As[k] = -INFINITY;
  __syncthreads();
  for (int k = threadIdx.x; k < S * s.nown; k += blockDim.x) {
    if (rows) {
      const int l = k / S, i = k - l * S;
      s.As[l * s.C + perm(i, s.L)] = A[(size_t)(s.j0 + l) * S + i];
    } else {
      const int i = k / s.nown, l = k - i * s.nown;
      s.As[l * s.C + perm(i, s.L)] = A[(size_t)i * S + s.j0 + l];
    }
  }
  __syncthreads();
}

// rows t in [t0, T) of out [T, S]: this block's states to v
__device__ void fill_rows(float* out, int t0, int T, int S, const Slice& s,
                          float v) {
  for (int k = threadIdx.x; k < (T - t0) * s.nown; k += blockDim.x) {
    const int t = t0 + k / s.nown;
    out[(size_t)t * S + s.j0 + k % s.nown] = v;
  }
}

// K: as graph_fb_kernel (no log_AT: backwards the blocks load rows).
__global__ void graph_fb_cluster_kernel(const float* __restrict__ log_A,
                                        const float* __restrict__ log_entry,
                                        const float* __restrict__ log_exit,
                                        const float* __restrict__ log_b,
                                        const int* __restrict__ n_frames,
                                        int T, int S, float* __restrict__ alpha,
                                        float* __restrict__ beta,
                                        float* __restrict__ like) {
  extern __shared__ float smem[];
  const Slice s = slice_of(S, smem);
  const int C = s.C;
  const float* A = log_A + (size_t)s.b * S * S;
  const float* en = log_entry + (size_t)s.b * S;
  const float* ex = log_exit + (size_t)s.b * S;
  const float* lb = log_b + (size_t)s.b * T * S;
  float* al = alpha + (size_t)s.b * T * S;
  float* be = beta + (size_t)s.b * T * S;
  const int n = n_frames[s.b];
  const int nl = min(max(n, 0), T);   // the frames that propagate
  const float* a = s.As + s.jl * C + s.q * s.L;   // this lane's sources
  float* mine = s.buf + perm(s.j, s.L);           // its state's place
  const unsigned bytes = 4u * S;
  unsigned ph = 0;

  // forwards: the column slice; every block started before any store
  init_block(s, S);
  load_slice(s, A, S, false);
  fill_rows(al, nl, T, S, s, NEG_INF_TRAIN);
  cluster_barrier();
  float lbv = s.ok && nl > 0 ? lb[s.j] : 0.0f;
  for (int t = 0; t < nl; ++t) {
    const int c = t & 1;
    if (threadIdx.x == 0) mbar_arm(s.mb + (c ^ 1), bytes);
    if (t > 0) mbar_wait(s.mb + c, ph, c);
    const float out =
        t == 0 ? (s.ok ? en[s.j] + lbv : 0.0f)
               : column_lse4(s.K4, s.ok, a, s.buf + c * C + s.q * s.L) + lbv;
    __syncthreads();   // buf[c] read: the peers may refill it
    if (s.ok) push_all(mine + (c ^ 1) * C, s.mb + (c ^ 1), s.nc, s.q, out);
    if (s.ok && s.q == 0) al[(size_t)t * S + s.j] = out;
    lbv = s.ok && t + 1 < nl ? lb[(size_t)(t + 1) * S + s.j] : 0.0f;
  }
  if (nl > 0) mbar_wait(s.mb + (nl & 1), ph, nl & 1);
  if (cluster_rank() == 0) {
    const float ll = like_lse(s.buf + (nl & 1) * C, ex, S, s.L, s.red);
    if (threadIdx.x == 0) like[s.b] = ll;
  }
  __syncthreads();

  // backwards, frame f = nl - 1 - t: the row slice; buf[f & 1] holds v =
  // log_b[t + 1] + beta_{t+1} (the peers' stores wait for block 0's lse)
  load_slice(s, A, S, true);
  if (n > T) {   // the first frame propagates from beta = NEG_INF
    for (int k = threadIdx.x; k < S; k += blockDim.x)
      s.buf[perm(k, s.L)] = lb[(size_t)(T - 1) * S + k] + NEG_INF_TRAIN;
  }
  fill_rows(be, nl, T, S, s, NEG_INF_TRAIN);
  const float exv = s.ok ? ex[s.j] : 0.0f;
  cluster_barrier();
  lbv = s.ok && nl > 1 ? lb[(size_t)(nl - 1) * S + s.j] : 0.0f;
  for (int f = 0; f < nl; ++f) {
    const int t = nl - 1 - f, c = f & 1;
    if (threadIdx.x == 0 && t > 0) mbar_arm(s.mb + (c ^ 1), bytes);
    if (f > 0) mbar_wait(s.mb + c, ph, c);
    const float nw = t == n - 1 ? exv
        : column_lse4(s.K4, s.ok, a, s.buf + c * C + s.q * s.L);
    __syncthreads();
    if (t > 0 && s.ok)
      push_all(mine + (c ^ 1) * C, s.mb + (c ^ 1), s.nc, s.q, lbv + nw);
    if (s.ok && s.q == 0) be[(size_t)t * S + s.j] = nw;
    lbv = s.ok && t > 1 ? lb[(size_t)(t - 1) * S + s.j] : 0.0f;
  }
  cluster_barrier();   // no block leaves while a peer may store into it
}

// K': as graph_align_kernel, the back-pointers in device memory, the final
// argmax and the walk back in block 0.
__global__ void graph_align_cluster_kernel(const float* __restrict__ log_A,
                                           const float* __restrict__ log_entry,
                                           const float* __restrict__ log_exit,
                                           const float* __restrict__ log_b,
                                           const int* __restrict__ n_frames,
                                           int T, int S, int* __restrict__ bps,
                                           int* __restrict__ states,
                                           float* __restrict__ like) {
  extern __shared__ float smem[];
  const Slice s = slice_of(S, smem);
  const int C = s.C;
  const float* A = log_A + (size_t)s.b * S * S;
  const float* en = log_entry + (size_t)s.b * S;
  const float* ex = log_exit + (size_t)s.b * S;
  const float* lb = log_b + (size_t)s.b * T * S;
  int* bp = bps + (size_t)s.b * T * S;
  const int n = n_frames[s.b];
  const int nl = min(max(n, 0), T);
  const float4* a4 = reinterpret_cast<const float4*>(s.As + s.jl * C + s.q * s.L);
  float* mine = s.buf + perm(s.j, s.L);
  const unsigned bytes = 4u * S;
  unsigned ph = 0;

  init_block(s, S);
  load_slice(s, A, S, false);
  cluster_barrier();
  float lbv = s.ok && nl > 0 ? lb[s.j] : 0.0f;
  for (int t = 0; t < nl; ++t) {
    const int c = t & 1;
    if (threadIdx.x == 0) mbar_arm(s.mb + (c ^ 1), bytes);
    if (t > 0) mbar_wait(s.mb + c, ph, c);
    const float4* v4 = reinterpret_cast<const float4*>(s.buf + c * C + s.q * s.L);
    float best = -INFINITY;
    int arg = 0x7fffffff;
    if (s.ok && s.q < S) {
      // the lane's sources four at a time, its first source first (the
      // pad entries, -inf, never win): source q + QC e of chunk k is e
      for (int k = 0; k < s.K4; ++k) {
        const float4 x = a4[k], y = v4[k];
        const float z[4] = {x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = s.q + QC * (4 * k + e);
          if (k == 0 && e == 0) best = z[0], arg = i;
          else if (z[e] > best) best = z[e], arg = i;   // the lane's first max
        }
      }
    }
    for (int o = 1; o < QC; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ov > best || (ov == best && oi < arg)) best = ov, arg = oi;
    }
    __syncthreads();
    if (s.ok)
      push_all(mine + (c ^ 1) * C, s.mb + (c ^ 1), s.nc, s.q,
               (t == 0 ? en[s.j] : best) + lbv);
    if (s.ok && s.q == 0) bp[(size_t)t * S + s.j] = arg;
    lbv = s.ok && t + 1 < nl ? lb[(size_t)(t + 1) * S + s.j] : 0.0f;
  }
  if (nl > 0) mbar_wait(s.mb + (nl & 1), ph, nl & 1);
  cluster_barrier();   // no block leaves while a peer may store into it

  if (cluster_rank() == 0) {
    // final argmax of alpha_last + exit: the larger value, on ties the
    // smaller index (any order of the reduction gives the same pair)
    const float* cur = s.buf + (nl & 1) * C;
    int* red_i = reinterpret_cast<int*>(s.red + 32);
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      const float x = cur[perm(j, s.L)] + ex[j];
      if (x > bv || (x == bv && j < bi)) bv = x, bi = j;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
    }
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    if (l == 0) s.red[w] = bv, red_i[w] = bi;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v0 = s.red[0];
      int i0 = red_i[0];
      for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
        const float ov = s.red[k];
        const int oi = red_i[k];
        if (ov > v0 || (ov == v0 && oi < i0)) v0 = ov, i0 = oi;
      }
      like[s.b] = v0;
      // the walk back (train/fb.py:160-168); the peers' back-pointers
      // through L2 (ordered by the cluster barrier's release and acquire)
      int carry = i0;
      int* st = states + (size_t)s.b * T;
      for (int t = T - 1; t >= 0; --t) {
        const int cu = t == n - 1 ? i0 : carry;
        st[t] = t < n ? cu : -1;
        carry = t <= n - 1 ? __ldcg(bp + (size_t)t * S + cu) : cu;
      }
    }
  }
}

// Set a cluster kernel's attributes and its launch configuration for B
// utterances of S states on clusters of c blocks; the dynamic shared
// memory is raised to ONE_BLOCK_AN_SM so each block has an SM of its own.
template <class Kernel>
cudaError_t cluster_config(Kernel kernel, int B, int S, int c,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  if (!cluster_fits(S, c)) return cudaErrorInvalidValue;
  const size_t need = cluster_smem(S, c);
  const size_t smem = need > ONE_BLOCK_AN_SM ? need : ONE_BLOCK_AN_SM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && c > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * c);
  cfg->blockDim = dim3(threads_for(QC * slice_cols(S, c), MAX_THREADS));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t launched(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return e != cudaSuccess ? e : last;
}

}  // namespace

// Bytes of device scratch a launch needs for B utterances of width W (P*S
// for J, S for K / K'): 0 where the carries fit in shared memory.
extern "C" long long trainfb_scratch_floats(int B, int W) {
  const size_t smem = (size_t)(32 + 2 * (size_t)W) * sizeof(float);
  return smem <= SMEM_LIMIT ? 0 : (long long)B * 2 * W;
}

// How many clusters of c blocks of K (which 0) or K' (which 1) at S states
// the card holds at once (cudaOccupancyMaxActiveClusters): 0 where the
// slice does not fit, minus the CUDA error where the query fails.
extern "C" int trainfb_cluster_max_active(int which, int S, int c) {
  if (!cluster_fits(S, c)) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t e = which ? cluster_config(graph_align_cluster_kernel, 1, S, c,
                                         nullptr, &cfg, &attr)
                        : cluster_config(graph_fb_cluster_kernel, 1, S, c,
                                         nullptr, &cfg, &attr);
  if (e == cudaSuccess)
    e = which ? cudaOccupancyMaxActiveClusters(
                    &n, (const void*)graph_align_cluster_kernel, &cfg)
              : cudaOccupancyMaxActiveClusters(
                    &n, (const void*)graph_fb_cluster_kernel, &cfg);
  cudaGetLastError();
  return e == cudaSuccess ? n : -(int)e;
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

extern "C" int graph_fb_cluster(const void* log_A, const void* log_entry,
                                const void* log_exit, const void* log_b,
                                const void* n_frames, int B, int T, int S,
                                int c, void* alpha, void* beta, void* like,
                                void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(graph_fb_cluster_kernel, B, S, c,
                                 static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e != cudaSuccess) return e;
  return launched(cudaLaunchKernelEx(
      &cfg, graph_fb_cluster_kernel, static_cast<const float*>(log_A),
      static_cast<const float*>(log_entry), static_cast<const float*>(log_exit),
      static_cast<const float*>(log_b), static_cast<const int*>(n_frames), T, S,
      static_cast<float*>(alpha), static_cast<float*>(beta),
      static_cast<float*>(like)));
}

extern "C" int graph_align_cluster(const void* log_A, const void* log_entry,
                                   const void* log_exit, const void* log_b,
                                   const void* n_frames, int B, int T, int S,
                                   int c, void* bps, void* states, void* like,
                                   void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(graph_align_cluster_kernel, B, S, c,
                                 static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (e != cudaSuccess) return e;
  return launched(cudaLaunchKernelEx(
      &cfg, graph_align_cluster_kernel, static_cast<const float*>(log_A),
      static_cast<const float*>(log_entry), static_cast<const float*>(log_exit),
      static_cast<const float*>(log_b), static_cast<const int*>(n_frames), T, S,
      static_cast<int*>(bps), static_cast<int*>(states),
      static_cast<float*>(like)));
}
