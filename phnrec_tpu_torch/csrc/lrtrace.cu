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
//   (the reference's indexing quirk, the serving default) or, with the
//   quirk off, the keyword's own cand_end.
//   flush: do = cond && cand_end != 0 && (!dumped || improved), improved
//   = cand_end != prev_end with improveKwdEstim on and false with it off
//   (the serving default); the event record takes (emit = do && cand_lr
//   >= score_pruning && live, cand_start, cand_end, cand_lr, dumped) from
//   before the flush; then prev_end = cand_end and dumped = true where do.
//   The two settings are template parameters (IMP, Q) beside time
//   pruning's (TP), so each instance's frame body holds no test of them.
//
// A dead frame writes its records (emit 0) and keeps the state.  Compares,
// selects and one subtraction per keyword: equal to the plain version.
//
// What bounds it on the H100: not bytes (~16 read and ~28 written per
// keyword and frame: microseconds at the memory rate for a serving block)
// but the instructions of one frame, repeated F times by one warp: the
// frames of a stream are sequential, and with one warp per stream there
// is about one warp for each of the card's schedulers, so nothing hides a
// stall but the warp's own instruction-level parallelism.  A frame that
// loads its three inputs from device memory and uses them at once pays a
// memory latency every frame (measured: ~780 clocks a frame, ~335 with
// every frame's loads from one frame), and ten scattered record stores a
// keyword and frame cost ~360 more.
//
// Design: one warp per stream (keyword k in lane k % 32, KPL keywords a
// lane), the whole frame loop inside the kernel, and no device memory on
// the frame's path:
// * the sink columns a stream needs are staged into shared memory CHUNK
//   frames ahead by cp.async, in a ring of STAGES stages, so chunk c+1
//   and c+2 arrive while chunk c runs; the frame loop reads shared memory
//   only (the next frame's values loaded while this one computes).  Where
//   a row of the records is 16-byte aligned and short (S % 4 == 0, S <=
//   ROW_MAX: the EN net's 4 sinks are 16 bytes) whole rows are copied, one
//   16-byte copy a row and array; otherwise only the K word columns and
//   the filler column, 4 bytes each (the EN net by columns alone: +41%);
// * the event records of a chunk go to shared memory, two 16-byte stores
//   a keyword and frame (start, end, score, and emit | new_estim << 8 of
//   each record), and out to device memory once per chunk, each field of
//   a stream's chunk one contiguous run;
// * the frame body has no branch and is unrolled by 2 (1: +20%, 4: +23%,
//   8: +42%), so one frame's stores and loads overlap the next frame's
//   compares; time pruning on or off is a template parameter, so the
//   body holds no test of it (-25%).
// Keyword 0's candidate end, which every keyword's time-pruning test
// reads, reaches the other lanes by a shuffle from the stream's first
// lane (each lane running keyword 0's take chain itself instead: +13%).
// Measured (PERF.md): a warp per block (4 a block: +1%), and a warp per
// stream (16 streams a warp, a lane per stream and keyword: 3.3x slower).
//
// Past MAX_K = 128 keywords (four a lane) the keywords run in groups of
// 128, one launch a group, each the kernel above on its group's columns,
// state and records (strided by the full K).  Keyword 0's candidate end
// is the time-pruning reference of every group: the first group's launch
// writes it a frame to a [n, F] scratch row (G_FIRST), and the later
// groups' launches read it from there, a chunk at a time staged beside
// their records (G_LATER), instead of the shuffle.  K <= 128 runs the
// single-group instance (G_ONE) as before.  Without the quirk (or without
// time pruning) no keyword reads another's candidate, so every group runs
// the G_LATER instance on its own and no scratch row is read or written.

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 1;           // warps per block
constexpr int CHUNK = 32;          // frames a ring stage (at most)
constexpr int STAGES = 3;
constexpr int ROW_MAX = 16;        // whole rows copied up to this many sinks
constexpr int MAX_K = 128;
constexpr int SMEM_BYTES = 48 * 1024 - 4 * MAX_K;  // dynamic, beside ws_s
constexpr int REC = 8;             // words of both event records a keyword and frame

// the launch's place among the keyword groups
enum Place { G_ONE = 0, G_FIRST = 1, G_LATER = 2 };

struct Rec {
  uint8_t* emit;
  int* start;
  int* end;
  float* score;
  uint8_t* new_estim;
};

struct Args {
  const float* sink_val;
  const int* sink_wt;
  const int* ws;
  const int* n_dec;
  const int* n_valid;
  int fs, F, n, S, K, tp_on, tp;
  int row;         // whole rows staged (else the K + 1 columns)
  int chunk;       // frames a stage
  int warp_words;  // shared memory a warp, in 4-byte words
  float sp, neg_half;
  const float* last_lr0;
  const float* cand_lr0;
  const int* cand_start0;
  const int* cand_end0;
  const int* prev_end0;
  const uint8_t* dumped0;
  float* last_lr1;
  float* cand_lr1;
  int* cand_start1;
  int* cand_end1;
  int* prev_end1;
  uint8_t* dumped1;
  Rec r1, r2;
};

// a launch's keyword group, past one group (the single group's kernel does
// not read it)
struct Group {
  int Kt, k0;  // all keywords (the stride of state and records), the first
  int* end0;   // [n, F] keyword 0's candidate end a frame
};

// Asynchronous global -> shared copies; dst and src aligned to the size.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// KPL keywords a lane; TP: time pruning on; G: the keyword group's place;
// IMP: improveKwdEstim on; Q: keyword 0's candidate end is every keyword's
// time-pruning reference (the quirk)
template <int KPL, bool TP, int G, bool IMP, bool Q>
__global__ void __launch_bounds__(WARPS * 32)
lrtrace_kernel(const Args a, const Group grp) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int ws_s[MAX_K];
  const int K = a.K, F = a.F, n = a.n, S = a.S, C = a.chunk;
  for (int k = threadIdx.x; k < K; k += WARPS * 32) ws_s[k] = a.ws[k];
  __syncthreads();

  // the stride of state and records and the group's first keyword (one
  // group: K and 0, the single-group instance's code unchanged)
  const int Kt = G == G_ONE ? K : grp.Kt, k0 = G == G_ONE ? 0 : grp.k0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;  // the warp's stream
  if (b >= n) return;  // the whole warp leaves together
  // a staged frame holds W words per array: the whole row, or the K word
  // columns then the filler column
  const int W = a.row ? S : K + 1;
  const int words = C * W;  // one array of one stage
  // a warp's part: the chunk's event records, REC words a (frame,
  // keyword), then the value and word-time rings
  int* rec = reinterpret_cast<int*>(ring + (size_t)warp * a.warp_words);
  float* vring = reinterpret_cast<float*>(rec + C * K * REC);
  int* wring = reinterpret_cast<int*>(vring + STAGES * words);
  int* e0s = wring + STAGES * words;  // keyword 0's ends of a chunk (groups)

  float last_lr[KPL], cand_lr[KPL];
  int cand_start[KPL], cand_end[KPL], prev_end[KPL], vi[KPL];
  bool dumped[KPL], has[KPL];
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int k = lane + 32 * i;
    has[i] = k < K;
    const size_t s = (size_t)b * Kt + k0 + k;
    last_lr[i] = has[i] ? a.last_lr0[s] : -INFINITY;
    cand_lr[i] = has[i] ? a.cand_lr0[s] : -INFINITY;
    cand_start[i] = has[i] ? a.cand_start0[s] : 0;
    cand_end[i] = has[i] ? a.cand_end0[s] : 0;
    prev_end[i] = has[i] ? a.prev_end0[s] : 0;
    dumped[i] = has[i] ? a.dumped0[s] != 0 : false;
    vi[i] = has[i] ? (a.row ? ws_s[k] : k) : 0;
  }
  const int fi = a.row ? a.fs : K;
  const int t0 = a.n_dec[b];
  const int nv = a.n_valid[b];

  // chunk c: frames c*C .. into stage c % STAGES, one commit group
  auto issue = [&](int c) {
    const int f0 = c * C, nf = min(C, F - f0);
    float* vd = vring + (c % STAGES) * words;
    int* wd = wring + (c % STAGES) * words;
    if (a.row) {
      const int q4 = S >> 2;
      for (int u = lane; u < nf * q4; u += 32) {
        const int q = u % q4, fr = u / q4;
        const size_t g = ((size_t)(f0 + fr) * n + b) * S + 4 * q;
        cp_async16(vd + fr * S + 4 * q, a.sink_val + g);
        cp_async16(wd + fr * S + 4 * q, a.sink_wt + g);
      }
    } else {
      const int w2 = 2 * K + 1;
      for (int u = lane; u < nf * w2; u += 32) {
        const int j = u % w2, fr = u / w2;
        const size_t g = ((size_t)(f0 + fr) * n + b) * S;
        if (j <= K)
          cp_async4(vd + fr * W + j, a.sink_val + g + (j < K ? ws_s[j] : a.fs));
        else
          cp_async4(wd + fr * W + j - K - 1, a.sink_wt + g + ws_s[j - K - 1]);
      }
    }
  };

  const int nch = (F + C - 1) / C;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    __syncwarp();  // every lane is done with the stage that chunk c+2 takes
    if (c + STAGES - 1 < nch) issue(c + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // chunk c has landed, for every lane
    __syncwarp();
    const int f0 = c * C, nf = min(C, F - f0);
    const float* vs = vring + (c % STAGES) * words;
    const int* wsm = wring + (c % STAGES) * words;
    if (G == G_LATER && Q) {
      // the first group's keyword-0 ends of this chunk's frames
      if (lane < nf) e0s[lane] = grp.end0[(size_t)b * F + f0 + lane];
      __syncwarp();
    }

    // this frame's inputs in registers, the next frame's loaded meanwhile
    float fl = vs[fi], wv[KPL];
    int w0[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      wv[i] = vs[vi[i]];
      w0[i] = wsm[vi[i]];
    }
    // (not by 3: nvcc 12.9 then emits the 3-frame body with no remainder,
    // one exit test every third frame, so a chunk of another length runs
    // past its last frame; 1, 2, 4 and 8 keep the remainder, PERF.md)
#pragma unroll 2
    for (int fr = 0; fr < nf; ++fr) {
      const int f = f0 + fr;
      const int t = t0 + f;
      const bool live = f < nv;
      const int fo = (fr + 1 < nf ? fr + 1 : fr) * W;
      const float fl_next = vs[fo + fi];
      float wv_next[KPL];
      int w0_next[KPL];
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        wv_next[i] = vs[fo + vi[i]];
        w0_next[i] = wsm[fo + vi[i]];
      }

      float n_lr[KPL], n_clr[KPL];
      int n_cs[KPL], n_ce[KPL], n_pe[KPL];
      bool n_d[KPL], act[KPL];
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const bool active = has[i] && wv[i] > a.neg_half && fl > a.neg_half;
        const float lr = active ? wv[i] - fl : -INFINITY;
        const bool growing = active && lr >= last_lr[i];
        const bool new_hyp = growing && cand_end[i] <= w0[i];
        const bool take = growing && (lr >= cand_lr[i] || new_hyp);
        const bool ev1 = new_hyp && take;
        // flush 1: the new-hypothesis flush of the old candidate
        const bool do1 = ev1 && cand_end[i] != 0 &&
                         (!dumped[i] || (IMP && cand_end[i] != prev_end[i]));
        int4* r = reinterpret_cast<int4*>(
            rec + (fr * K + lane + 32 * i) * REC);
        if (has[i])
          r[0] = make_int4(cand_start[i], cand_end[i],
                           __float_as_int(cand_lr[i]),
                           (int)(do1 && cand_lr[i] >= a.sp && live) |
                               (int)dumped[i] << 8);
        n_pe[i] = do1 ? cand_end[i] : prev_end[i];
        n_d[i] = (dumped[i] || do1) && !ev1;
        n_cs[i] = take ? w0[i] : cand_start[i];
        n_ce[i] = take ? t + 1 : cand_end[i];
        n_clr[i] = take ? lr : cand_lr[i];
        n_lr[i] = active ? lr : -INFINITY;
        act[i] = active;
      }
      // keyword 0's updated candidate end, for every lane of the stream
      // (the quirk's reference; unused without it)
      int end0 = 0;
      if (Q) {
        end0 = G == G_LATER ? e0s[fr] : __shfl_sync(0xffffffffu, n_ce[0], 0);
        if (G == G_FIRST && lane == 0) e0s[fr] = end0;
      }
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int ref = Q ? end0 : n_ce[i];
        const bool stale = act[i] && ref != 0 && (t + 1) - ref >= a.tp;
        const bool do2 = TP && stale && n_ce[i] != 0 &&
                         (!n_d[i] || (IMP && n_ce[i] != n_pe[i]));
        int4* r = reinterpret_cast<int4*>(
            rec + (fr * K + lane + 32 * i) * REC);
        if (has[i])
          r[1] = make_int4(TP ? n_cs[i] : 0, TP ? n_ce[i] : 0,
                           __float_as_int(TP ? n_clr[i] : 0.f),
                           (int)(do2 && n_clr[i] >= a.sp && live) |
                               (int)(TP && n_d[i]) << 8);
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
        wv[i] = wv_next[i];
        w0[i] = w0_next[i];
      }
      fl = fl_next;
    }
    // the chunk's records, the nf * K of each field contiguous (a group:
    // K contiguous a frame, strided by all keywords)
    __syncwarp();
    if (G == G_FIRST && Q && lane < nf)
      grp.end0[(size_t)b * F + f0 + lane] = e0s[lane];
    const size_t g = ((size_t)b * F + f0) * Kt + k0;
    for (int u = lane; u < nf * K; u += 32) {
      const int4 x = reinterpret_cast<const int4*>(rec + u * REC)[0];
      const int4 y = reinterpret_cast<const int4*>(rec + u * REC)[1];
      const size_t o = G == G_ONE ? g + u : g + (size_t)(u / K) * Kt + u % K;
      a.r1.emit[o] = (uint8_t)(x.w & 1);
      a.r1.start[o] = x.x;
      a.r1.end[o] = x.y;
      a.r1.score[o] = __int_as_float(x.z);
      a.r1.new_estim[o] = (uint8_t)(x.w >> 8);
      a.r2.emit[o] = (uint8_t)(y.w & 1);
      a.r2.start[o] = y.x;
      a.r2.end[o] = y.y;
      a.r2.score[o] = __int_as_float(y.z);
      a.r2.new_estim[o] = (uint8_t)(y.w >> 8);
    }
  }

#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    if (!has[i]) continue;
    const size_t s = (size_t)b * Kt + k0 + lane + 32 * i;
    a.last_lr1[s] = last_lr[i];
    a.cand_lr1[s] = cand_lr[i];
    a.cand_start1[s] = cand_start[i];
    a.cand_end1[s] = cand_end[i];
    a.prev_end1[s] = prev_end[i];
    a.dumped1[s] = dumped[i];
  }
}

template <int KPL, int G, bool IMP, bool Q>
cudaError_t launch(Args a, const Group& grp, cudaStream_t st) {
  const int W = a.row ? a.S : a.K + 1;
  // a warp's words a frame: two rings of STAGES, the records; a group's
  // launch also a word a frame of keyword 0's ends; each warp's part a
  // multiple of 16 bytes
  const int per_frame = STAGES * 2 * W + a.K * REC + (G != G_ONE);
  a.chunk = std::min(CHUNK, (SMEM_BYTES / (4 * WARPS) - 3) / per_frame);
  if (a.chunk < 1) return cudaErrorInvalidValue;
  a.warp_words = (a.chunk * per_frame + 3) & ~3;
  const unsigned blocks = (unsigned)((a.n + WARPS - 1) / WARPS);
  const size_t smem = (size_t)WARPS * a.warp_words * 4;
  // the quirk only with time pruning on (scan() clears it otherwise)
  if constexpr (Q)
    lrtrace_kernel<KPL, true, G, IMP, true>
        <<<blocks, WARPS * 32, smem, st>>>(a, grp);
  else if (a.tp_on)
    lrtrace_kernel<KPL, true, G, IMP, false>
        <<<blocks, WARPS * 32, smem, st>>>(a, grp);
  else
    lrtrace_kernel<KPL, false, G, IMP, false>
        <<<blocks, WARPS * 32, smem, st>>>(a, grp);
  return cudaGetLastError();
}

template <int G, bool IMP, bool Q>
cudaError_t launch_kpl(const Args& a, const Group& grp, cudaStream_t st) {
  // the first of several groups holds MAX_K keywords
  if constexpr (G == G_FIRST) {
    return launch<MAX_K / 32, G, IMP, Q>(a, grp, st);
  } else {
    switch ((a.K + 31) / 32) {
      case 1: return launch<1, G, IMP, Q>(a, grp, st);
      case 2: return launch<2, G, IMP, Q>(a, grp, st);
      case 3: return launch<3, G, IMP, Q>(a, grp, st);
      case 4: return launch<4, G, IMP, Q>(a, grp, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

// K <= MAX_K keywords in one launch, or groups of MAX_K: with the quirk
// the first writes keyword 0's ends and the others read them; without it
// each group runs on its own.  Each group's word columns start at its first
template <bool IMP, bool Q>
cudaError_t launch_groups(Args a, Group grp, cudaStream_t st) {
  const int K = a.K;
  const int* ws = a.ws;
  if (K <= MAX_K) return launch_kpl<G_ONE, IMP, Q>(a, grp, st);
  for (int k0 = 0; k0 < K; k0 += MAX_K) {
    grp.k0 = k0;
    a.K = std::min(MAX_K, K - k0);
    a.ws = ws + k0;
    cudaError_t err;
    if constexpr (Q)
      err = k0 == 0 ? launch_kpl<G_FIRST, IMP, Q>(a, grp, st)
                    : launch_kpl<G_LATER, IMP, Q>(a, grp, st);
    else
      err = launch_kpl<G_LATER, IMP, Q>(a, grp, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// keywords one launch takes; more run in groups of this many
extern "C" int lrtrace_max_keywords() { return MAX_K; }

namespace {

cudaError_t scan(const void* sink_val, const void* sink_wt, const void* ws,
                 int fs, const void* n_dec, const void* n_valid, int F, int n,
                 int S, int K, int tp_on, int tp, float sp, float neg_half,
                 const void* last_lr0, const void* cand_lr0,
                 const void* cand_start0, const void* cand_end0,
                 const void* prev_end0, const void* dumped0, void* last_lr1,
                 void* cand_lr1, void* cand_start1, void* cand_end1,
                 void* prev_end1, void* dumped1, void* e1, void* s1, void* en1,
                 void* sc1, void* ne1, void* e2, void* s2, void* en2,
                 void* sc2, void* ne2, void* end0, int improve, int quirk,
                 void* stream) {
  if (n <= 0) return cudaSuccess;
  quirk = quirk && tp_on;
  if (F < 0 || S <= 0 || K <= 0 || fs < 0 || fs >= S ||
      (K > MAX_K && quirk && end0 == nullptr))
    return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(sink_val) |
                        reinterpret_cast<uintptr_t>(sink_wt)) % 16 == 0;
  Args a{static_cast<const float*>(sink_val), static_cast<const int*>(sink_wt),
         static_cast<const int*>(ws), static_cast<const int*>(n_dec),
         static_cast<const int*>(n_valid), fs, F, n, S, K, tp_on, tp,
         (int)(S % 4 == 0 && S <= ROW_MAX && aligned), 0, 0, sp, neg_half,
         static_cast<const float*>(last_lr0),
         static_cast<const float*>(cand_lr0),
         static_cast<const int*>(cand_start0),
         static_cast<const int*>(cand_end0),
         static_cast<const int*>(prev_end0),
         static_cast<const uint8_t*>(dumped0), static_cast<float*>(last_lr1),
         static_cast<float*>(cand_lr1), static_cast<int*>(cand_start1),
         static_cast<int*>(cand_end1), static_cast<int*>(prev_end1),
         static_cast<uint8_t*>(dumped1),
         Rec{static_cast<uint8_t*>(e1), static_cast<int*>(s1),
             static_cast<int*>(en1), static_cast<float*>(sc1),
             static_cast<uint8_t*>(ne1)},
         Rec{static_cast<uint8_t*>(e2), static_cast<int*>(s2),
             static_cast<int*>(en2), static_cast<float*>(sc2),
             static_cast<uint8_t*>(ne2)}};
  auto st = static_cast<cudaStream_t>(stream);
  const Group grp{K, 0, static_cast<int*>(end0)};
  if (improve)
    return quirk ? launch_groups<true, true>(a, grp, st)
                 : launch_groups<true, false>(a, grp, st);
  return quirk ? launch_groups<false, true>(a, grp, st)
               : launch_groups<false, false>(a, grp, st);
}

}  // namespace

// The LRTrace scan over one block: sink records [F, n, S] (f32 values, i32
// word times), word-sink columns ws [K] i32, filler column fs, n_dec and
// n_valid i32 [n]; state in/out six [n, K] arrays (f32 last_lr, cand_lr;
// i32 cand_start, cand_end, prev_end; u8 dumped); two event records of
// five [n, F, K] arrays each (u8 emit, i32 start, i32 end, f32 score, u8
// new_estim).  Takes K <= MAX_K.  Launches on `stream`, allocates nothing,
// does not synchronise.
extern "C" int lrtrace_scan(
    const void* sink_val, const void* sink_wt, const void* ws, int fs,
    const void* n_dec, const void* n_valid, int F, int n, int S, int K,
    int tp_on, int tp, float sp, float neg_half, const void* last_lr0,
    const void* cand_lr0, const void* cand_start0, const void* cand_end0, const void* prev_end0, const void* dumped0,
    void* last_lr1, void* cand_lr1, void* cand_start1, void* cand_end1,
    void* prev_end1, void* dumped1, void* e1, void* s1, void* en1, void* sc1,
    void* ne1, void* e2, void* s2, void* en2, void* sc2, void* ne2,
    void* stream) {
  return scan(sink_val, sink_wt, ws, fs, n_dec, n_valid, F, n, S, K, tp_on,
              tp, sp, neg_half, last_lr0, cand_lr0, cand_start0, cand_end0,
              prev_end0, dumped0, last_lr1, cand_lr1, cand_start1, cand_end1,
              prev_end1, dumped1, e1, s1, en1, sc1, ne1, e2, s2, en2, sc2, ne2,
              nullptr, 0, 1, stream);
}

// The same for any K and LRTrace's two settings: improve (improveKwdEstim)
// and quirk (keyword 0's candidate end the time-pruning reference of every
// keyword; lrtrace_scan is improve 0, quirk 1).  Past MAX_K keywords, one
// launch a group of MAX_K; with the quirk and time pruning on, `end0` is an
// [n, F] i32 scratch row (keyword 0's candidate end a frame), else unread.
extern "C" int lrtrace_scan_settings(
    const void* sink_val, const void* sink_wt, const void* ws, int fs,
    const void* n_dec, const void* n_valid, int F, int n, int S, int K,
    int tp_on, int tp, float sp, float neg_half, const void* last_lr0,
    const void* cand_lr0, const void* cand_start0, const void* cand_end0,
    const void* prev_end0, const void* dumped0, void* last_lr1,
    void* cand_lr1, void* cand_start1, void* cand_end1, void* prev_end1,
    void* dumped1, void* e1, void* s1, void* en1, void* sc1, void* ne1,
    void* e2, void* s2, void* en2, void* sc2, void* ne2, void* end0,
    int improve, int quirk, void* stream) {
  return scan(sink_val, sink_wt, ws, fs, n_dec, n_valid, F, n, S, K, tp_on,
              tp, sp, neg_half, last_lr0, cand_lr0, cand_start0, cand_end0,
              prev_end0, dumped0, last_lr1, cand_lr1, cand_start1, cand_end1,
              prev_end1, dumped1, e1, s1, en1, sc1, ne1, e2, s2, en2, sc2, ne2,
              end0, improve, quirk, stream);
}
