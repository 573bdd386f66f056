// Device backtrack of phoneme-loop histories into compact segments, for
// sm_90a.
//
// Replaces: phnrec_tpu/decoder/phnloop.py::_backtrack_device_impl (an XLA
// lax.scan over segment slots; it has no Pallas twin): kernel D, called by
// backtrack_device, and kernel D', the committed-window form of
// backtrack_device_committed (phnloop.py:328-348).
// PhnDec::Done (phndec.cpp:236-302) as a walk: from end = n_frames[b], while
// end > f0 and fewer than Smax segments were emitted, read the History record
// at end-1 (winner phoneme, entry frame, score), emit it, and hop end to its
// entry frame.  Segments come out in reverse time order; slots past the
// count are exactly 0, which labels_from_segments relies on for the
// reference's initial mPrevAlpha = 0.
//
// D' walks a retained window whose row i is global frame row_offset[b] + i
// and stops at the committed boundary frame0[b] (global): f0 = max(frame0 -
// row_offset, 0), and each entry frame is rebased to window rows as
// max(ent - row_offset, f0), which clamps the earliest segment's start to
// the boundary.  Kernel D is the form with no frame0/row_offset pointers
// (both 0): there max(ent, 0) == ent, since entry frames are never
// negative.  Starts are window rows, so the 20-bit packing limit of the JAX
// walk applies to the window length, not the session.
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
                                 const int* __restrict__ n_frames,
                                 const int* __restrict__ frame0,
                                 const int* __restrict__ row_offset, int T,
                                 int B, int smax, int* __restrict__ count,
                                 int8_t* __restrict__ phn,
                                 StartT* __restrict__ start,
                                 float* __restrict__ alpha_end) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t base = (size_t)b * smax;
  const int ro = row_offset ? row_offset[b] : 0;
  const int f0 = frame0 ? max(frame0[b] - ro, 0) : 0;
  int end = n_frames[b];
  int k = 0;
  for (; k < smax && end > f0; ++k) {
    const int t = min(end - 1, T - 1);
    const size_t h = (size_t)t * B + b;
    const int st = max(ent[h] - ro, f0);
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
// start_bytes == 2, else i32), alpha_end [B, smax] f32.  frame0 and
// row_offset ([B] i32) are both null (kernel D) or both set (kernel D').
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int phn_backtrack(const void* max_phn, const void* ent,
                             const void* alpha, const void* n_frames,
                             const void* frame0, const void* row_offset, int T,
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
  auto* f0 = static_cast<const int*>(frame0);
  auto* ro = static_cast<const int*>(row_offset);
  auto* ct = static_cast<int*>(count);
  auto* ph = static_cast<int8_t*>(phn);
  auto* ae = static_cast<float*>(alpha_end);
  if (start_bytes == 2)
    backtrack_kernel<int16_t><<<blocks, threads, 0, s>>>(
        mp, en, al, nf, f0, ro, T, B, smax, ct, ph, static_cast<int16_t*>(start), ae);
  else
    backtrack_kernel<int><<<blocks, threads, 0, s>>>(
        mp, en, al, nf, f0, ro, T, B, smax, ct, ph, static_cast<int*>(start), ae);
  return cudaGetLastError();
}
