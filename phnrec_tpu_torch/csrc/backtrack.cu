// Device backtrack of phoneme-loop histories into compact segments, for
// sm_90a.
//
// Replaces: phnrec_tpu/decoder/phnloop.py::_backtrack_device_impl (an XLA
// lax.scan over segment slots; it has no Pallas twin), with frame0 = 0.
// PhnDec::Done (phndec.cpp:236-302) as a walk: from end = n_frames[b], while
// end > 0 and fewer than Smax segments were emitted, read the History record
// at end-1 (winner phoneme, entry frame, score), emit it, and hop end to its
// entry frame.  Segments come out in reverse time order; slots past the
// count are exactly 0, which labels_from_segments relies on for the
// reference's initial mPrevAlpha = 0.
//
// What bounds it on the H100: a chain of dependent loads, one hop per
// segment (T/S hops at most), so latency; the bytes touched are ~9 per
// segment, against the 9 per frame a host walk would fetch.
//
// Design: one thread per utterance, walking its own chain; the batch gives
// the parallelism.  Output rows are written in place, no scatter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename StartT>
__global__ void backtrack_kernel(const int8_t* __restrict__ max_phn,
                                 const int* __restrict__ ent,
                                 const float* __restrict__ alpha,
                                 const int* __restrict__ n_frames, int T,
                                 int B, int smax, int* __restrict__ count,
                                 int8_t* __restrict__ phn,
                                 StartT* __restrict__ start,
                                 float* __restrict__ alpha_end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t base = (size_t)b * smax;
  int end = n_frames[b];
  int k = 0;
  for (; k < smax && end > 0; ++k) {
    const int t = min(end - 1, T - 1);
    const size_t h = (size_t)t * B + b;
    const int st = ent[h];
    phn[base + k] = max_phn[h];
    start[base + k] = (StartT)st;
    alpha_end[base + k] = alpha[h];
    end = st;
  }
  count[b] = k;
  for (; k < smax; ++k) {
    phn[base + k] = 0;
    start[base + k] = 0;
    alpha_end[base + k] = 0.0f;
  }
}

}  // namespace

// History [T, B] (i8 winner, i32 entry frame, f32 score) and n_frames [B]
// -> count [B] i32, phn [B, smax] i8, start [B, smax] (i16 when
// start_bytes == 2, else i32), alpha_end [B, smax] f32.  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int phn_backtrack(const void* max_phn, const void* ent,
                             const void* alpha, const void* n_frames, int T,
                             int B, int smax, int start_bytes, void* count,
                             void* phn, void* start, void* alpha_end,
                             void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T <= 0 || smax <= 0 || (start_bytes != 2 && start_bytes != 4))
    return cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto* mp = static_cast<const int8_t*>(max_phn);
  auto* en = static_cast<const int*>(ent);
  auto* al = static_cast<const float*>(alpha);
  auto* nf = static_cast<const int*>(n_frames);
  auto* ct = static_cast<int*>(count);
  auto* ph = static_cast<int8_t*>(phn);
  auto* ae = static_cast<float*>(alpha_end);
  if (start_bytes == 2)
    backtrack_kernel<int16_t><<<blocks, threads, 0, s>>>(
        mp, en, al, nf, T, B, smax, ct, ph, static_cast<int16_t*>(start), ae);
  else
    backtrack_kernel<int><<<blocks, threads, 0, s>>>(
        mp, en, al, nf, T, B, smax, ct, ph, static_cast<int*>(start), ae);
  return cudaGetLastError();
}
