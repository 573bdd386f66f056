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
// What bounds it on the H100: not bytes (~P*S*4 of log-posteriors a frame
// and utterance: microseconds at the memory rate for a serving block) but
// the instructions of one frame, repeated T times by one warp: the state
// update, then a loop-wide argmax whose winner is the next frame's entry
// value.  With one warp per utterance there is about one warp for each of
// the card's schedulers, so nothing hides a stall but the warp's own
// instruction-level parallelism.  Observations fetched one frame ahead
// straight from device memory (a serving block's log-posteriors, 72 MB,
// do not fit the 50 MB L2) are hidden only behind the argmax (measured:
// ~850 clocks a frame, ~450 with every frame's observations from one
// frame; a 5-step shuffle butterfly for the argmax is ~25 of them).
//
// Design: one warp per utterance and the whole frame loop inside the
// kernel, one launch per batch.  Lanes own phonemes (p = lane + 32*i, PPL
// per lane), the carry lives in registers for the whole block.
// * Each utterance's observations are staged into shared memory a chunk
//   of frames ahead by cp.async, in a ring of STAGES stages: a chunk is
//   one contiguous span of the utterance's rows (D floats a row; a CZ row
//   is 552 bytes, 8-byte aligned, so the span's unaligned head and tail go
//   by 4-byte copies and the rest by 16-byte ones, the shared copy offset
//   to keep them aligned), and only the frames a row runs (< n_valid) are
//   read.  The frame loop reads shared memory only, the next frame's
//   observations loaded while this frame's argmax runs.
// * The argmax is a register pass over a lane's phonemes (strict >: its
//   lowest phoneme wins ties), one redux.sync max over the lanes' bests
//   as ordered integer keys, a ballot per phoneme slot of FLOAT equality
//   with that max (so -0.0 and +0.0 tie, as under the compare of the plain
//   version and argmax), the lowest (slot, lane) of the ballots being the
//   lowest phoneme, and one shuffle each of the winner's own value and
//   entry frame.
// * The frame body has no branch and is unrolled: a frame's argmax waits
//   only on its exit states, which need the entry value S frames back, so
//   for S >= 2 the argmaxes of successive frames overlap (unrolled: ~320
//   clocks a frame; the same body not unrolled: ~455).  Every lane writes
//   the frame's History record to shared memory (the same words), and the
//   chunk's records go out once per chunk, a lane a frame (-6%).
//
// Any other width: the templates above take S <= MAX_S = 5 states and rows
// of D <= phn_viterbi_max_row() columns (a ring stage).  Past either, one
// kernel with S a run-time value (viterbi_any_kernel) runs the same
// arithmetic in the same order, a warp per utterance: the carry lives in
// shared memory ([P][S + 1] alphas and entry frames, each lane touching
// only its own phonemes' words), and only the P*S columns the scan reads
// are staged, a frame ahead, by 4-byte cp.async into a two-frame buffer.
// Where the carry and the buffer exceed a block's shared memory (S past
// ~100 at P 128) the carry stays in the output carry's own device memory
// and the observations are read from device memory.  Bit-equal as above;
// P <= 128 in every form, as the History's int8 winner holds no more.

#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 1;            // utterances per block
constexpr int CHUNK = 16;           // frames a ring stage (at most)
constexpr int STAGES = 3;
constexpr int SMEM_BYTES = 48 * 1024;
constexpr int MAX_S = 5;            // states the templates take
constexpr int MAX_P = 128;          // phonemes an int8 History names
constexpr size_t SMEM_MAX = 232448; // a block's dynamic shared memory

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floats a 16-byte aligned span starts before `p`
__device__ __forceinline__ int misalign(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// the integer that orders floats as their values do (no NaN here)
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// the largest of the warp's keys
__device__ __forceinline__ int warp_max_key(int key) {
  return __reduce_max_sync(0xffffffffu, key);
}

template <int S, int PPL>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ carry_a,
               const int* __restrict__ carry_e,
               const float* __restrict__ log_post, int B, int T, int P, int D,
               int t0, const int* __restrict__ t0_row,
               const int* __restrict__ n_valid, float w_pen, float tr_curr,
               float tr_next, float* __restrict__ out_a, int* __restrict__ out_e,
               int8_t* __restrict__ h_phn, int* __restrict__ h_ent,
               float* __restrict__ h_alpha, int C, int stage_words) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int tb = t0_row ? t0_row[b] : t0;
  const int nv = n_valid ? max(0, min(n_valid[b], T)) : T;
  float* wring =
      ring + (size_t)(threadIdx.x >> 5) * (STAGES * stage_words + 3 * CHUNK);
  int* hist = reinterpret_cast<int*>(wring + STAGES * stage_words);

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

  // chunk c: frames c*C .. (below nv), one contiguous span, into stage
  // c % STAGES at the span's own offset from 16 bytes; one commit group
  const float* up = log_post + (size_t)b * T * D;
  auto issue = [&](int c) {
    const float* src = up + (size_t)c * C * D;
    const int len = min(C, nv - c * C) * D;
    const int mis = misalign(src);
    float* dst = wring + (c % STAGES) * stage_words + mis;
    const int head = min((4 - mis) & 3, len);
    const int pieces = (len - head) >> 2;
    const int tail = len - head - 4 * pieces;
    for (int u = lane; u < pieces; u += 32)
      cp_async16(dst + head + 4 * u, src + head + 4 * u);
    if (lane < head) cp_async4(dst + lane, src + lane);
    if (lane < tail)
      cp_async4(dst + head + 4 * pieces + lane, src + head + 4 * pieces + lane);
  };

  const bool valid = lane < P;  // the lane holds a phoneme
  const int nch = (nv + C - 1) / C;
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
    const int f0 = c * C, nf = min(C, nv - f0);
    const float* ob = wring + (c % STAGES) * stage_words +
                      misalign(up + (size_t)f0 * D);

    float obs[PPL][S];
#pragma unroll
    for (int i = 0; i < PPL; ++i)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int p = lane + 32 * i;
        obs[i][s] = p < P ? ob[p * S + s] : 0.0f;
      }

    // straight-line frames (no branch inside), unrolled: a frame's argmax
    // waits only on its exit states, which the frame before computed, so
    // the argmaxes of successive frames can overlap (for S >= 2).  (Not by
    // 3: nvcc 12.9 then emits the 3-frame body with no remainder, one exit
    // test every third frame, so a chunk of another length runs past its
    // last frame and its History buffer; 4 keeps the remainder, PERF.md.)
#pragma unroll 4
    for (int tt = 0; tt < nf; ++tt) {
      const int t = f0 + tt;
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

      // the next frame's observations, from shared memory (the chunk's
      // last frame reads its own again)
      {
        const float* row = ob + min(tt + 1, nf - 1) * D;
#pragma unroll
        for (int i = 0; i < PPL; ++i)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int p = lane + 32 * i;
            obs[i][s] = p < P ? row[p * S + s] : 0.0f;
          }
      }

      // loop argmax over exit states; the lowest phoneme wins ties.  The
      // lane's own best first (its lowest slot among equals) ...
      float bv = a[0][S];
      int bi = 0, be = e[0][S];
#pragma unroll
      for (int i = 1; i < PPL; ++i) {
        const float v = a[i][S];
        if (lane + 32 * i < P && v > bv) {
          bv = v;
          bi = i;
          be = e[i][S];
        }
      }
      // ... then the warp's max, and the lowest phoneme equal to it
      const int mk = warp_max_key(valid ? order_key(bv) : (int)0x80000000);
      const float mx = __int_as_float(mk >= 0 ? mk : mk ^ 0x7fffffff);
      const bool tie = valid && bv == mx;
      unsigned m = 0;
      int wi = 0;
#pragma unroll
      for (int i = PPL - 1; i >= 0; --i) {
        const unsigned mi = __ballot_sync(0xffffffffu, tie && bi == i);
        if (mi) {
          m = mi;
          wi = i;
        }
      }
      const int wl = __ffs(m) - 1;
      const float wv = __shfl_sync(0xffffffffu, bv, wl);
      const int we = __shfl_sync(0xffffffffu, be, wl);

      const float entry = wv + w_pen;
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        a[i][0] = entry;
        e[i][0] = tb + t + 1;
      }
      // every lane writes the same record (one write a store)
      hist[tt * 3] = wl + 32 * wi;
      hist[tt * 3 + 1] = we;
      hist[tt * 3 + 2] = __float_as_int(wv);
    }
    // the chunk's History, a lane a frame
    __syncwarp();
    if (lane < nf) {
      const size_t h = (size_t)(f0 + lane) * B + b;
      h_phn[h] = (int8_t)hist[lane * 3];
      h_ent[h] = hist[lane * 3 + 1];
      h_alpha[h] = __int_as_float(hist[lane * 3 + 2]);
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

// Any S and D: a warp per utterance, S a run-time value.  With `in_smem`
// the carry [P][S + 1] and a two-frame buffer of the P*S read columns sit
// in shared memory; without, the carry is updated in out_a / out_e
// ([P, S + 1, B], strided by B) and the observations read from device
// memory.  The same adds, compares and argmax as viterbi_kernel.
__global__ void __launch_bounds__(32)
viterbi_any_kernel(const float* __restrict__ carry_a,
                   const int* __restrict__ carry_e,
                   const float* __restrict__ log_post, int B, int T, int P,
                   int S, int D, int t0, const int* __restrict__ t0_row,
                   const int* __restrict__ n_valid, float w_pen,
                   float tr_curr, float tr_next, float* out_a, int* out_e,
                   int8_t* __restrict__ h_phn, int* __restrict__ h_ent,
                   float* __restrict__ h_alpha, int in_smem) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tb = t0_row ? t0_row[b] : t0;
  const int nv = n_valid ? max(0, min(n_valid[b], T)) : T;
  const int S1 = S + 1, PS = P * S, ppl = (P + 31) / 32;
  // the carry, [P][S + 1] words strided by cs
  float* A;
  int* E;
  size_t cs;
  float* obuf = nullptr;
  if (in_smem) {
    A = sm;
    E = reinterpret_cast<int*>(sm + (size_t)P * S1);
    obuf = sm + 2 * (size_t)P * S1;
    cs = 1;
  } else {
    A = out_a + b;
    E = out_e + b;
    cs = B;
  }
  for (int j = lane; j < P * S1; j += 32) {
    A[j * cs] = carry_a[(size_t)j * B + b];
    E[j * cs] = carry_e[(size_t)j * B + b];
  }
  const float* up = log_post + (size_t)b * T * D;
  // frame t's P*S read columns into buffer t & 1
  auto issue = [&](int t) {
    float* dst = obuf + (t & 1) * PS;
    const float* src = up + (size_t)t * D;
    for (int j = lane; j < PS; j += 32) cp_async4(dst + j, src + j);
  };
  if (in_smem && nv > 0) issue(0);
  cp_async_commit();
  const bool valid = lane < P;
  for (int t = 0; t < nv; ++t) {
    const float* ob = up + (size_t)t * D;
    if (in_smem) {
      if (t + 1 < nv) issue(t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // frame t has landed, for every lane
      __syncwarp();
      ob = obuf + (t & 1) * PS;
    }
    // states high-to-low, each reading the previous frame's s-1; then the
    // lane's own best exit (its lowest phoneme among equals)
    float bv = -INFINITY;
    int bi = 0, be = 0;
    for (int i = 0; i < ppl; ++i) {
      const int p = lane + 32 * i;
      if (p < P) {
        float* ap = A + (size_t)p * S1 * cs;
        int* ep = E + (size_t)p * S1 * cs;
        const float* op = ob + p * S;
        for (int s = S; s >= 1; --s) {
          const float cur = ap[s * cs] + tr_curr;
          const float prev = ap[(s - 1) * cs] + tr_next;
          const bool take_cur = cur > prev;
          ap[s * cs] = (take_cur ? cur : prev) + op[s - 1];
          if (!take_cur) ep[s * cs] = ep[(s - 1) * cs];
        }
        const float v = ap[S * cs];
        if (i == 0 || v > bv) {
          bv = v;
          bi = i;
          be = ep[S * cs];
        }
      }
    }
    const int mk = warp_max_key(valid ? order_key(bv) : (int)0x80000000);
    const float mx = __int_as_float(mk >= 0 ? mk : mk ^ 0x7fffffff);
    const bool tie = valid && bv == mx;
    unsigned m = 0;
    int wi = 0;
    for (int i = ppl - 1; i >= 0; --i) {
      const unsigned mi = __ballot_sync(0xffffffffu, tie && bi == i);
      if (mi) {
        m = mi;
        wi = i;
      }
    }
    const int wl = __ffs(m) - 1;
    const float wv = __shfl_sync(0xffffffffu, bv, wl);
    const int we = __shfl_sync(0xffffffffu, be, wl);
    for (int i = 0; i < ppl; ++i) {
      const int p = lane + 32 * i;
      if (p < P) {
        A[(size_t)p * S1 * cs] = wv + w_pen;
        E[(size_t)p * S1 * cs] = tb + t + 1;
      }
    }
    if (lane == 0) {
      const size_t h = (size_t)t * B + b;
      h_phn[h] = (int8_t)(wl + 32 * wi);
      h_ent[h] = we;
      h_alpha[h] = wv;
    }
    __syncwarp();  // every lane is done with the buffer frame t + 2 takes
  }
  if (in_smem) {
    for (int j = lane; j < P * S1; j += 32) {
      out_a[(size_t)j * B + b] = A[j];
      out_e[(size_t)j * B + b] = E[j];
    }
  }
}

cudaError_t launch_any(const float* ca, const int* ce, const float* lp, int B,
                       int T, int P, int S, int D, int t0, const int* t0r,
                       const int* nv, float w_pen, float tr_curr,
                       float tr_next, float* oa, int* oe, int8_t* hp, int* he,
                       float* ha, cudaStream_t stream) {
  // the carry's two words and two buffered observations a (phoneme, state)
  const size_t smem = sizeof(float) * (2 * (size_t)P * (S + 1) +
                                       2 * (size_t)P * S);
  const bool in_smem = smem <= SMEM_MAX;
  if (in_smem && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_any_kernel<<<(unsigned)B, 32, in_smem ? smem : 0, stream>>>(
      ca, ce, lp, B, T, P, S, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa,
      oe, hp, he, ha, (int)in_smem);
  return cudaGetLastError();
}

template <int S, int PPL>
cudaError_t launch(const float* ca, const int* ce, const float* lp, int B,
                   int T, int P, int D, int t0, const int* t0r, const int* nv,
                   float w_pen, float tr_curr, float tr_next, float* oa,
                   int* oe, int8_t* hp, int* he, float* ha,
                   cudaStream_t stream) {
  // C frames a stage, the span's offset (< 4 floats) beside them, each
  // stage a multiple of 16 bytes
  const int C = std::min(
      CHUNK, ((SMEM_BYTES / (4 * WARPS) - 3 * CHUNK) / STAGES - 7) / D);
  if (C < 1) return cudaErrorInvalidValue;
  const int stage_words = (C * D + 3 + 3) & ~3;
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  viterbi_kernel<S, PPL>
      <<<blocks, WARPS * 32,
         (size_t)WARPS * (STAGES * stage_words + 3 * CHUNK) * 4,
         stream>>>(ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr,
                   tr_next, oa, oe, hp, he, ha, C, stage_words);
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

// the most states and the widest frame row (D, a stage of the ring) the
// templates take; past them the run-time-S kernel runs
extern "C" int phn_viterbi_max_states() { return MAX_S; }
extern "C" int phn_viterbi_max_phonemes() { return MAX_P; }
extern "C" int phn_viterbi_max_row() {
  return (SMEM_BYTES / (4 * WARPS) - 3 * CHUNK) / STAGES - 7;
}
// 1 where the call takes the run-time-S kernel
extern "C" int phn_viterbi_any_path(int S, int D) {
  return S > MAX_S || D > phn_viterbi_max_row();
}

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
  if (P <= 0 || P > MAX_P || S <= 0 || D < P * S || T < 0)
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
  if (phn_viterbi_any_path(S, D))
    return launch_any(ca, ce, lp, B, T, P, S, D, t0, t0r, nv, w_pen, tr_curr,
                      tr_next, oa, oe, hp, he, ha, s);
  switch (S) {
    case 1: return dispatch_ppl<1>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 2: return dispatch_ppl<2>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 3: return dispatch_ppl<3>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 4: return dispatch_ppl<4>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    case 5: return dispatch_ppl<5>(ppl, ca, ce, lp, B, T, P, D, t0, t0r, nv, w_pen, tr_curr, tr_next, oa, oe, hp, he, ha, s);
    default: return cudaErrorInvalidValue;
  }
}
