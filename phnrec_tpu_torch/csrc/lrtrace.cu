// LRTrace keyword-candidate scan over F frames for n streams, for sm_90a.
//
// Replaces: phnrec_tpu/decoder/stknet.py::lrtrace_step_fn (:1114-1177),
// run in the JAX package as a vmapped lax.scan over the network block's
// sink records (phnrec_tpu/multistream.py:1017-1036); it has no Pallas
// twin.  Per stream, frame f (global frame t = n_dec + f, live while
// f < n_valid) and keyword k (stkinterface.cpp:240-289, 349-380):
//
//   wv = sink_val[f, b, ws[k]], fl = sink_val[f, b, fs],
//   w0 = sink_wt[f, b, ws[k]]
//   active = wv > NEG/2 && fl > NEG/2;  lr = active ? wv - fl : -inf
//   growing = active && lr >= last_lr;  new_hyp = growing && cand_end <= w0
//   take = growing && (lr >= cand_lr || new_hyp)
//   flush 1 (new hypothesis) where new_hyp && take, then dumped = false;
//   the candidate takes (w0, t + 1, lr) where take; last_lr follows lr;
//   flush 2 (time pruning, when enabled) where active, ref_end != 0 and
//   t + 1 - ref_end >= time_pruning, ref_end being KEYWORD 0's cand_end
//   (the reference's indexing quirk, kept).
//   flush: do = cond && cand_end != 0 && !dumped (improveKwdEstim off, the
//   serving default); the event record takes (emit = do && cand_lr >=
//   score_pruning && live, cand_start, cand_end, cand_lr, dumped) from
//   before the flush; then prev_end = cand_end and dumped = true where do.
//
// A dead frame writes its records (emit 0) and keeps the state.  Compares,
// selects and one subtraction per keyword: equal to the plain version.
//
// What bounds it on the H100: a sequential state machine over frames, a
// few dozen dependent instructions per frame; latency-bound, with ~16
// bytes read and ~40 written per keyword and frame.
//
// Design: one warp per stream, keyword k in lane k % 32 (KPL keywords a
// lane), the whole frame loop inside the kernel.  Keyword 0's candidate
// end, which every keyword's time-pruning test reads, reaches the other
// lanes by a shuffle from lane 0, so a stream's coupled lanes stay in
// one warp.  The kernel gathers the word and filler sink columns out of
// the network block's [F, n, S] records itself.  Latency is hidden across
// streams.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // streams per block

struct Rec {
  uint8_t* emit;
  int* start;
  int* end;
  float* score;
  uint8_t* new_estim;
};

template <int KPL>
__global__ void __launch_bounds__(WARPS * 32) lrtrace_kernel(
    const float* __restrict__ sink_val, const int* __restrict__ sink_wt,
    const int* __restrict__ ws, int fs, const int* __restrict__ n_dec,
    const int* __restrict__ n_valid, int F, int n, int S, int K,
    int tp_on, int tp, float sp, float neg_half,
    const float* __restrict__ last_lr0, const float* __restrict__ cand_lr0,
    const int* __restrict__ cand_start0, const int* __restrict__ cand_end0,
    const int* __restrict__ prev_end0, const uint8_t* __restrict__ dumped0,
    float* __restrict__ last_lr1, float* __restrict__ cand_lr1,
    int* __restrict__ cand_start1, int* __restrict__ cand_end1,
    int* __restrict__ prev_end1, uint8_t* __restrict__ dumped1, Rec r1,
    Rec r2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= n) return;  // the whole warp leaves together

  float last_lr[KPL], cand_lr[KPL];
  int cand_start[KPL], cand_end[KPL], prev_end[KPL], col[KPL];
  bool dumped[KPL], has[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + 32 * i;
    has[i] = k < K;
    const size_t s = (size_t)b * K + (has[i] ? k : 0);
    last_lr[i] = has[i] ? last_lr0[s] : -INFINITY;
    cand_lr[i] = has[i] ? cand_lr0[s] : -INFINITY;
    cand_start[i] = has[i] ? cand_start0[s] : 0;
    cand_end[i] = has[i] ? cand_end0[s] : 0;
    prev_end[i] = has[i] ? prev_end0[s] : 0;
    dumped[i] = has[i] ? dumped0[s] != 0 : false;
    col[i] = has[i] ? ws[k] : 0;
  }
  const int t0 = n_dec[b];
  const int nv = n_valid[b];

  for (int f = 0; f < F; ++f) {
    const int t = t0 + f;
    const bool live = f < nv;
    const size_t row = ((size_t)f * n + b) * S;
    const float fl = sink_val[row + fs];
    float n_lr[KPL], n_clr[KPL];
    int n_cs[KPL], n_ce[KPL], n_pe[KPL];
    bool n_d[KPL], act[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const float wv = has[i] ? sink_val[row + col[i]] : -INFINITY;
      const int w0 = has[i] ? sink_wt[row + col[i]] : 0;
      const bool active = has[i] && wv > neg_half && fl > neg_half;
      const float lr = active ? wv - fl : -INFINITY;
      const bool growing = active && lr >= last_lr[i];
      const bool new_hyp = growing && cand_end[i] <= w0;
      const bool take = growing && (lr >= cand_lr[i] || new_hyp);
      const bool ev1 = new_hyp && take;
      // flush 1: the new-hypothesis flush of the old candidate
      const bool do1 = ev1 && cand_end[i] != 0 && !dumped[i];
      if (has[i]) {
        const size_t o = ((size_t)b * F + f) * K + lane + 32 * i;
        r1.emit[o] = do1 && cand_lr[i] >= sp && live;
        r1.start[o] = cand_start[i];
        r1.end[o] = cand_end[i];
        r1.score[o] = cand_lr[i];
        r1.new_estim[o] = dumped[i];
      }
      n_pe[i] = do1 ? cand_end[i] : prev_end[i];
      n_d[i] = (dumped[i] || do1) && !ev1;
      n_cs[i] = take ? w0 : cand_start[i];
      n_ce[i] = take ? t + 1 : cand_end[i];
      n_clr[i] = take ? lr : cand_lr[i];
      n_lr[i] = active ? lr : -INFINITY;
      act[i] = active;
    }
    // keyword 0's updated candidate end, for every lane
    const int end0 = __shfl_sync(0xffffffffu, n_ce[0], 0);
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      bool do2 = false;
      if (tp_on) {
        const bool stale = act[i] && end0 != 0 && (t + 1) - end0 >= tp;
        do2 = stale && n_ce[i] != 0 && !n_d[i];
      }
      if (has[i]) {
        const size_t o = ((size_t)b * F + f) * K + lane + 32 * i;
        r2.emit[o] = do2 && n_clr[i] >= sp && live;
        r2.start[o] = tp_on ? n_cs[i] : 0;
        r2.end[o] = tp_on ? n_ce[i] : 0;
        r2.score[o] = tp_on ? n_clr[i] : 0.f;
        r2.new_estim[o] = tp_on ? n_d[i] : false;
      }
      if (do2) {
        n_pe[i] = n_ce[i];
        n_d[i] = true;
      }
      if (live) {
        last_lr[i] = n_lr[i];
        cand_lr[i] = n_clr[i];
        cand_start[i] = n_cs[i];
        cand_end[i] = n_ce[i];
        prev_end[i] = n_pe[i];
        dumped[i] = n_d[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    if (!has[i]) continue;
    const size_t s = (size_t)b * K + lane + 32 * i;
    last_lr1[s] = last_lr[i];
    cand_lr1[s] = cand_lr[i];
    cand_start1[s] = cand_start[i];
    cand_end1[s] = cand_end[i];
    prev_end1[s] = prev_end[i];
    dumped1[s] = dumped[i];
  }
}

}  // namespace

extern "C" int lrtrace_max_keywords() { return 128; }

// The LRTrace scan over one block: sink records [F, n, S] (f32 values, i32
// word times), word-sink columns ws [K] i32, filler column fs, n_dec and
// n_valid i32 [n]; state in/out six [n, K] arrays (f32 last_lr, cand_lr;
// i32 cand_start, cand_end, prev_end; u8 dumped); two event records of
// five [n, F, K] arrays each (u8 emit, i32 start, i32 end, f32 score, u8
// new_estim).  Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int lrtrace_scan(
    const void* sink_val, const void* sink_wt, const void* ws, int fs,
    const void* n_dec, const void* n_valid, int F, int n, int S, int K,
    int tp_on, int tp, float sp, float neg_half, const void* last_lr0,
    const void* cand_lr0, const void* cand_start0, const void* cand_end0, const void* prev_end0, const void* dumped0,
    void* last_lr1, void* cand_lr1, void* cand_start1, void* cand_end1,
    void* prev_end1, void* dumped1, void* e1, void* s1, void* en1, void* sc1,
    void* ne1, void* e2, void* s2, void* en2, void* sc2, void* ne2,
    void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F < 0 || S <= 0 || K <= 0 || K > 128 || fs < 0 || fs >= S)
    return cudaErrorInvalidValue;
  const Rec r1{static_cast<uint8_t*>(e1), static_cast<int*>(s1),
               static_cast<int*>(en1), static_cast<float*>(sc1),
               static_cast<uint8_t*>(ne1)};
  const Rec r2{static_cast<uint8_t*>(e2), static_cast<int*>(s2),
               static_cast<int*>(en2), static_cast<float*>(sc2),
               static_cast<uint8_t*>(ne2)};
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  auto st = static_cast<cudaStream_t>(stream);
#define LRT_LAUNCH(KPL)                                                      \
  lrtrace_kernel<KPL><<<blocks, WARPS * 32, 0, st>>>(                        \
      static_cast<const float*>(sink_val), static_cast<const int*>(sink_wt), \
      static_cast<const int*>(ws), fs, static_cast<const int*>(n_dec),       \
      static_cast<const int*>(n_valid), F, n, S, K, tp_on, tp, sp, neg_half, \
      static_cast<const float*>(last_lr0),                                   \
      static_cast<const float*>(cand_lr0),                                   \
      static_cast<const int*>(cand_start0),                                  \
      static_cast<const int*>(cand_end0),                                    \
      static_cast<const int*>(prev_end0),                                    \
      static_cast<const uint8_t*>(dumped0), static_cast<float*>(last_lr1),   \
      static_cast<float*>(cand_lr1), static_cast<int*>(cand_start1),         \
      static_cast<int*>(cand_end1), static_cast<int*>(prev_end1),            \
      static_cast<uint8_t*>(dumped1), r1, r2)
  switch ((K + 31) / 32) {
    case 1: LRT_LAUNCH(1); break;
    case 2: LRT_LAUNCH(2); break;
    case 3: LRT_LAUNCH(3); break;
    case 4: LRT_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef LRT_LAUNCH
  return cudaGetLastError();
}
