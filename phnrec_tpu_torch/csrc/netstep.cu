// Dense network-Viterbi block over F frames for n streams, for sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_netstep.py::build_net_block_fn (the
// Pallas kernel `kernel`, pallas_netstep.py:110-207, called at :231).
// Semantics per stream and frame (ViterbiStep on a uniform-S left-to-right
// network; E states, M models of S_M states each, S sinks):
//
//   in-model pass, state e of model m = e / S_M:
//     self  = alpha[e]   + w_self[e]
//     adv   = alpha[e-1] + w_adv[e]        (NEG weight at a model's first)
//     entry = entry[m]   + w_entry[e]      (NEG weight past the first)
//     a'[e] = best of (self, adv, entry), ties entry > adv > self (>=),
//             its word time wt' from the same source; a'[e] += obs[e]
//   beam:   a' < max_e a' - beam  ->  NEG
//   exit:   x[m] = a'[(m+1)*S_M - 1] + w_exit[m]  (word time alongside)
//   closure: entry'[m] = max over live edges r -> m of x[r] + A_cm[r, m],
//             sources ascending, strict-greater updates; below the beam
//             threshold -> NEG; its word time is n_dec + 1 + f when the
//             winning edge crosses a word (R_cm), else the source's
//   sinks:  sink_val[s] = max over live edges r -> s of x[r] + A_cs[r, s]
//
// A frame f >= n_valid leaves the carry as it was (its sink records are
// still written, from the carry).  Adds and compares only: the records are
// bit-equal to DenseKWSScan.step on live entries.
//
// What bounds it on the H100: the frame loop is sequential and each frame
// needs a block-wide max (the beam) and two dependent passes (exit, then
// closure), so it is latency-bound: ~6 barriers per frame and a few
// hundred bytes of observations per stream and frame, far below the
// memory rate.
//
// Design: one thread block per stream, one thread per state (and per
// model, and per sink: blockDim = max(E, M, S) rounded to a warp).  The
// carry lives in shared memory for the whole block of frames, double
// buffered so a frame reads the old carry while writing the new one; a
// dead frame simply does not swap.  The next frame's observation is
// loaded before the current frame's closure so its latency overlaps the
// barriers.  The closure and sink edges come as per-destination lists
// built on the host (ascending source), so a thread walks only its
// destination's live edges.  Latency is hidden across streams: n blocks
// in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused by the next frame
  return m;
}

__global__ void net_block_kernel(
    const float* __restrict__ obs, const float* __restrict__ alpha0,
    const int* __restrict__ wt0, const float* __restrict__ entry0,
    const int* __restrict__ ewt0, const float* __restrict__ w_self,
    const float* __restrict__ w_adv, const float* __restrict__ w_entry,
    const float* __restrict__ w_exit, const int* __restrict__ cm_ptr,
    const int* __restrict__ cm_src, const float* __restrict__ cm_w,
    const int* __restrict__ cm_reset, const int* __restrict__ cs_ptr,
    const int* __restrict__ cs_src, const float* __restrict__ cs_w,
    const int* __restrict__ n_valid, const int* __restrict__ n_dec,
    const float* __restrict__ beam, int F, int n, int E, int M, int S,
    int S_M, float* __restrict__ alpha_out, int* __restrict__ wt_out,
    float* __restrict__ entry_out, int* __restrict__ ewt_out,
    float* __restrict__ sink_val, int* __restrict__ sink_wt) {
  extern __shared__ float smem[];
  // [2][E] alpha, [2][E] wt, [2][M] entry, [2][M] entry_wt, [M] exit
  // value, [M] exit word time, [32] reduction
  float* alpha_s = smem;
  int* wt_s = reinterpret_cast<int*>(alpha_s + 2 * E);
  float* entry_s = reinterpret_cast<float*>(wt_s + 2 * E);
  int* ewt_s = reinterpret_cast<int*>(entry_s + 2 * M);
  float* xv_s = reinterpret_cast<float*>(ewt_s + 2 * M);
  int* xw_s = reinterpret_cast<int*>(xv_s + M);
  float* red = reinterpret_cast<float*>(xw_s + M);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nv = n_valid[b];
  const int t_base = n_dec[b] + 1;
  const float bm = beam[b];

  // thread tid owns state tid, model tid and sink tid where they exist
  const bool has_e = tid < E, has_m = tid < M, has_s = tid < S;
  float ws = 0.f, wa = 0.f, we = 0.f, wx = 0.f;
  int m_of_e = 0;
  if (has_e) {
    ws = w_self[tid];
    wa = w_adv[tid];
    we = w_entry[tid];
    m_of_e = tid / S_M;
    alpha_s[tid] = alpha0[(size_t)b * E + tid];
    wt_s[tid] = wt0[(size_t)b * E + tid];
  }
  int cm_lo = 0, cm_hi = 0, cs_lo = 0, cs_hi = 0;
  if (has_m) {
    wx = w_exit[tid];
    entry_s[tid] = entry0[(size_t)b * M + tid];
    ewt_s[tid] = ewt0[(size_t)b * M + tid];
    cm_lo = cm_ptr[tid];
    cm_hi = cm_ptr[tid + 1];
  }
  if (has_s) {
    cs_lo = cs_ptr[tid];
    cs_hi = cs_ptr[tid + 1];
  }
  int cur = 0;  // which half of each double buffer holds the carry
  float o = (has_e && F > 0) ? obs[(size_t)b * E + tid] : 0.f;
  __syncthreads();

  for (int f = 0; f < F; ++f) {
    const int nxt = cur ^ 1;
    const float* a_c = alpha_s + cur * E;
    const int* w_c = wt_s + cur * E;
    const float* en_c = entry_s + cur * M;
    const int* ew_c = ewt_s + cur * M;

    // -- in-model pass
    float na = -INFINITY;
    int nw = 0;
    if (has_e) {
      na = a_c[tid] + ws;
      nw = w_c[tid];
      const float adv = (tid > 0 ? a_c[tid - 1] : NEG) + wa;
      if (adv >= na) {
        na = adv;
        nw = tid > 0 ? w_c[tid - 1] : 0;
      }
      const float ent = en_c[m_of_e] + we;
      if (ent >= na) {
        na = ent;
        nw = ew_c[m_of_e];
      }
      na = na + o;
      if (f + 1 < F) o = obs[((size_t)(f + 1) * n + b) * E + tid];
    }
    // -- beam against the stream's best state
    const float thresh = block_max(na, red) - bm;
    if (has_e) {
      alpha_s[nxt * E + tid] = na >= thresh ? na : NEG;
      wt_s[nxt * E + tid] = nw;
    }
    __syncthreads();

    // -- exit pass: the last state of each model
    if (has_m) {
      const int last = (tid + 1) * S_M - 1;
      xv_s[tid] = alpha_s[nxt * E + last] + wx;
      xw_s[tid] = wt_s[nxt * E + last];
    }
    __syncthreads();

    // -- closure (exits -> entries) and sinks
    if (has_m) {
      float v = NEG;
      int w = 0, rs = 0;
      for (int j = cm_lo; j < cm_hi; ++j) {
        const int r = cm_src[j];
        const float c = xv_s[r] + cm_w[j];
        if (c > v) {
          v = c;
          w = xw_s[r];
          rs = cm_reset[j];
        }
      }
      entry_s[nxt * M + tid] = v >= thresh ? v : NEG;
      ewt_s[nxt * M + tid] = rs ? t_base + f : w;
    }
    if (has_s) {
      float v = NEG;
      int w = 0;
      for (int j = cs_lo; j < cs_hi; ++j) {
        const int r = cs_src[j];
        const float c = xv_s[r] + cs_w[j];
        if (c > v) {
          v = c;
          w = xw_s[r];
        }
      }
      const size_t idx = ((size_t)f * n + b) * S + tid;
      sink_val[idx] = v;
      sink_wt[idx] = w;
    }
    __syncthreads();
    if (f < nv) cur = nxt;  // a dead frame keeps the carry
  }

  if (has_e) {
    alpha_out[(size_t)b * E + tid] = alpha_s[cur * E + tid];
    wt_out[(size_t)b * E + tid] = wt_s[cur * E + tid];
  }
  if (has_m) {
    entry_out[(size_t)b * M + tid] = entry_s[cur * M + tid];
    ewt_out[(size_t)b * M + tid] = ewt_s[cur * M + tid];
  }
}

}  // namespace

// One block of frames of the dense network step for n streams: obs
// [F, n, E] f32; carry alpha/wt [n, E], entry/entry_wt [n, M]; structured
// weights w_self/w_adv/w_entry [E], w_exit [M]; closure lists by
// destination model (cm_ptr [M+1], cm_src/cm_w/cm_reset) and by sink
// (cs_ptr [S+1], cs_src/cs_w); n_valid/n_dec i32 [n], beam f32 [n] ->
// carry out and sink records [F, n, S].  `threads` = max(E, M, S) rounded
// up to a warp.  Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int net_block(
    const void* obs, const void* alpha0, const void* wt0, const void* entry0,
    const void* ewt0, const void* w_self, const void* w_adv,
    const void* w_entry, const void* w_exit, const void* cm_ptr,
    const void* cm_src, const void* cm_w, const void* cm_reset,
    const void* cs_ptr, const void* cs_src, const void* cs_w,
    const void* n_valid, const void* n_dec, const void* beam, int F, int n,
    int E, int M, int S, int S_M, int threads, void* alpha_out, void* wt_out,
    void* entry_out, void* ewt_out, void* sink_val, void* sink_wt,
    void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F < 0 || E <= 0 || M <= 0 || S <= 0 || S_M <= 0 || E != M * S_M ||
      threads % 32 || threads > 1024 || threads < E || threads < M ||
      threads < S)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (4 * (size_t)E + 6 * (size_t)M + 32);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  net_block_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<const float*>(alpha0),
      static_cast<const int*>(wt0), static_cast<const float*>(entry0),
      static_cast<const int*>(ewt0), static_cast<const float*>(w_self),
      static_cast<const float*>(w_adv), static_cast<const float*>(w_entry),
      static_cast<const float*>(w_exit), static_cast<const int*>(cm_ptr),
      static_cast<const int*>(cm_src), static_cast<const float*>(cm_w),
      static_cast<const int*>(cm_reset), static_cast<const int*>(cs_ptr),
      static_cast<const int*>(cs_src), static_cast<const float*>(cs_w),
      static_cast<const int*>(n_valid), static_cast<const int*>(n_dec),
      static_cast<const float*>(beam), F, n, E, M, S, S_M,
      static_cast<float*>(alpha_out), static_cast<int*>(wt_out),
      static_cast<float*>(entry_out), static_cast<int*>(ewt_out),
      static_cast<float*>(sink_val), static_cast<int*>(sink_wt));
  return cudaGetLastError();
}
