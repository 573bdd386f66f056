// Phoneme-loop Viterbi scan over a block of frames, for sm_90a.
//
// Replaces: phnrec_tpu/decoder/phnloop.py::viterbi_block (kernel C) and
// ::viterbi_block_ragged (kernel C', the multi-stream form), XLA lax.scans
// with no Pallas twin.  Semantics (PhnDec, phndec.cpp:96-144), per frame t
// and phoneme p, states 1..S of the carry (column 0 is the loop entry):
//
//   cur  = a[s] + tr_curr            (self-loop)
//   prev = a[s-1] + tr_next          (advance)
//   a'[s] = (cur > prev ? cur : prev) + obs[p*S + s-1]   (advance wins ties)
//   e'[s] = cur > prev ? e[s] : e[s-1]
//   winner = lowest p among the maxima of a'[S]
//   a'[0] = max + w_pen, e'[0] = t0 + t + 1
//
// and emits History (winner, its entry frame, the max) for the frame.  In
// the ragged form each utterance b has its own t0[b] and runs only its first
// n_valid[b] frames: past them its carry stays as it was and its History
// rows are left unwritten (undefined, as JAX's are garbage).  Kernel C is
// the form with no per-row pointers (t0 for all, n_valid = T).  The
// arithmetic is adds and compares only, so the History is bit-equal to
// JAX's on the same log-posteriors.
//
// What bounds it on the H100: the frame loop is sequential and each frame
// carries a loop-wide argmax, so the scan is latency-bound (a few hundred
// cycles per frame for one utterance); the data is ~P*S*4 bytes of
// log-posteriors per frame and utterance, far below the memory rate.
//
// Design: one warp per utterance and the whole frame loop inside the kernel,
// one launch per batch.  Lanes own phonemes (p = lane + 32*i, PPL per lane),
// the carry lives in registers for the whole block, the argmax is a
// register pass then a 5-step shuffle butterfly on (value, index, entry),
// and the next frame's observations are loaded before the current frame is
// reduced so their latency overlaps the shuffles.  Latency is hidden across
// utterances: a batch of B puts B warps in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // utterances per block

template <int S, int PPL>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ carry_a,
               const int* __restrict__ carry_e,
               const float* __restrict__ log_post, int B, int T, int P, int D,
               int t0, const int* __restrict__ t0_row,
               const int* __restrict__ n_valid, float w_pen, float tr_curr,
               float tr_next, float* __restrict__ out_a, int* __restrict__ out_e,
               int8_t* __restrict__ h_phn, int* __restrict__ h_ent,
               float* __restrict__ h_alpha) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int tb = t0_row ? t0_row[b] : t0;
  const int nv = n_valid ? max(0, min(n_valid[b], T)) : T;

  float a[PPL][S + 1];
  int e[PPL][S + 1];
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = lane + 32 * i;
#pragma unroll
    for (int s = 0; s <= S; ++s) {
      const size_t idx = ((size_t)p * (S + 1) + s) * B + b;
      a[i][s] = p < P ? carry_a[idx] : -INFINITY;
      e[i][s] = p < P ? carry_e[idx] : 0;
    }
  }

  const float* up = log_post + (size_t)b * T * D;
  float obs[PPL][S];
#pragma unroll
  for (int i = 0; i < PPL; ++i)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = lane + 32 * i;
      obs[i][s] = (p < P && nv > 0) ? up[p * S + s] : 0.0f;
    }

  for (int t = 0; t < nv; ++t) {
    // states update high-to-low, each reading the previous frame's s-1
#pragma unroll
    for (int i = 0; i < PPL; ++i)
#pragma unroll
      for (int s = S; s >= 1; --s) {
        const float cur = a[i][s] + tr_curr;
        const float prev = a[i][s - 1] + tr_next;
        const bool take_cur = cur > prev;
        a[i][s] = (take_cur ? cur : prev) + obs[i][s - 1];
        e[i][s] = take_cur ? e[i][s] : e[i][s - 1];
      }

    // prefetch the next frame's observations
    if (t + 1 < nv) {
      const float* row = up + (size_t)(t + 1) * D;
#pragma unroll
      for (int i = 0; i < PPL; ++i)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int p = lane + 32 * i;
          if (p < P) obs[i][s] = row[p * S + s];
        }
    }

    // loop argmax over exit states; the lowest phoneme wins ties
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    int be = 0;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int p = lane + 32 * i;
      const float v = a[i][S];
      if (p < P && (v > bv || (v == bv && p < bi))) {
        bv = v;
        bi = p;
        be = e[i][S];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oe = __shfl_xor_sync(0xffffffffu, be, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
        be = oe;
      }
    }

    const float entry = bv + w_pen;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      a[i][0] = entry;
      e[i][0] = tb + t + 1;
    }
    if (lane == 0) {
      const size_t h = (size_t)t * B + b;
      h_phn[h] = (int8_t)bi;
      h_ent[h] = be;
      h_alpha[h] = bv;
    }
  }

#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int p = lane + 32 * i;
    if (p >= P) continue;
#pragma unroll
    for (int s = 0; s <= S; ++s) {
      const size_t idx = ((size_t)p * (S + 1) + s) * B + b;
      out_a[idx] = a[i][s];
      out_e[idx] = e[i][s];
    }
  }
}

template <int S, int PPL>
cudaError_t launch(const float* ca, const int* ce, const float* lp, int B,
                   int T, int P, int D, int t0, const int* t0r, const int* nv,
                   float w_pen, float tr_curr, float tr_next, float* oa,
                   int* oe, int8_t* hp, int* he, float* ha,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  viterbi_kernel<S, PPL><<<blocks, WARPS * 32, 0, stream>>>(
      ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe,
      hp, he, ha);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch_ppl(int ppl, const float* ca, const int* ce,
                         const float* lp, int B, int T, int P, int D, int t0,
                         const int* t0r, const int* nv, float w_pen,
                         float tr_curr, float tr_next, float* oa, int* oe,
                         int8_t* hp, int* he, float* ha, cudaStream_t s) {
  switch (ppl) {
    case 1: return launch<S, 1>(ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 2: return launch<S, 2>(ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 3: return launch<S, 3>(ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 4: return launch<S, 4>(ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int phn_viterbi_max_states() { return 5; }
extern "C" int phn_viterbi_max_phonemes() { return 128; }

// One block of frames of the phoneme-loop scan.  carry [P, S+1, B]
// (alphas f32, entry frames i32) -> out carry; log_post [B, T, D] f32 with
// D >= P*S; History [T, B] (i8 winner, i32 entry frame, f32 score).  With
// t0_row and n_valid ([B] i32) null this is kernel C, every utterance at
// frame t0 for T frames; with both set, kernel C' (ragged).  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int phn_viterbi(const void* carry_a, const void* carry_e,
                           const void* log_post, int B, int T, int P, int S,
                           int D, int t0, const void* t0_row,
                           const void* n_valid, float w_pen, float tr_curr,
                           float tr_next, void* out_a, void* out_e,
                           void* h_phn, void* h_ent, void* h_alpha,
                           void* stream) {
  if (B <= 0) return cudaSuccess;
  if (P <= 0 || P > 128 || S <= 0 || S > 5 || D < P * S || T < 0)
    return cudaErrorInvalidValue;
  const int ppl = (P + 31) / 32;
  auto* ca = static_cast<const float*>(carry_a);
  auto* ce = static_cast<const int*>(carry_e);
  auto* lp = static_cast<const float*>(log_post);
  auto* t0r = static_cast<const int*>(t0_row);
  auto* nv = static_cast<const int*>(n_valid);
  auto* oa = static_cast<float*>(out_a);
  auto* oe = static_cast<int*>(out_e);
  auto* hp = static_cast<int8_t*>(h_phn);
  auto* he = static_cast<int*>(h_ent);
  auto* ha = static_cast<float*>(h_alpha);
  auto s = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return dispatch_ppl<1>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 2: return dispatch_ppl<2>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 3: return dispatch_ppl<3>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 4: return dispatch_ppl<4>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 5: return dispatch_ppl<5>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    default: return cudaErrorInvalidValue;
  }
}
