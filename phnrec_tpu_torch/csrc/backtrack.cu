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
// What bounds it on the H100: not bytes (~9 a hop read, 7 a slot written)
// but a chain of dependent loads, one hop per segment, and the stores of
// every output slot, most of them the zero-fill past the count.  Measured
// with a thread per utterance: slots stored by their row's own thread (a
// sector a store) take ~78% of the walk at B 256 x T 500, and a chain
// through device memory ~400 clocks a hop.
//
// Design: a block walks G consecutive utterances, a warp each.
// * The block streams its G columns of entry frames into shared memory
//   backwards, CHUNK frames at a time, through a cp.async ring of STAGES
//   stages, starting from the chunk that holds the block's latest end.  A
//   frame's G entry frames are one 32-byte sector, two 16-byte copies when
//   the rows are 16-byte aligned (else G 4-byte ones).  Hops only go
//   backwards, so each warp hops inside the staged chunk on shared memory
//   alone (~130 clocks a hop at the serving shape), and one barrier a
//   chunk recycles its stage.  A hop that went forward (no History of a
//   scan has one) leaves that loop and reads device memory.
// * Every lane of a warp walks the row (the same shared word, a
//   broadcast); lane k % 32 keeps segment k's frame and start.  Each 32
//   segments the lanes load their segments' winners and scores from
//   device memory, a lane each, and store them to consecutive slots at the
//   next 32 (or at the end), so those loads overlap the walk.  Staging the
//   winners and scores too would cost every warp a chunk's copies and two
//   more shared loads a hop (measured slower).  The zero-fill past the count goes
//   by 16-byte stores where the row's alignment allows, as soon as the
//   warp's walk ends.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8;                // utterances a block, a warp each
constexpr int CHUNK = 512;          // frames a ring stage
constexpr int STAGES = 2;           // STAGES - 1 chunks in flight

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Zero bytes [p, p + n) by the warp's lanes: 16-byte stores over the
// aligned middle, single bytes at the ends.
__device__ __forceinline__ void zero_bytes(char* p, int n, int lane) {
  const int head = min((int)((16 - ((uintptr_t)p & 15)) & 15), n);
  if (lane < head) p[lane] = 0;
  p += head;
  n -= head;
  uint4* q = reinterpret_cast<uint4*>(p);
  const int nv = n >> 4;
  for (int i = lane; i < nv; i += 32) q[i] = make_uint4(0, 0, 0, 0);
  p += nv << 4;
  n -= nv << 4;
  if (lane < n) p[lane] = 0;
}

template <typename StartT>
__global__ void __launch_bounds__(G * 32)
backtrack_kernel(const int8_t* __restrict__ max_phn,
                 const int* __restrict__ ent,
                 const float* __restrict__ alpha,
                 const int* __restrict__ n_frames,
                 const int* __restrict__ frame0,
                 const int* __restrict__ row_offset, int T, int B, int smax,
                 int* __restrict__ count, int8_t* __restrict__ phn,
                 StartT* __restrict__ start, float* __restrict__ alpha_end) {
  __shared__ __align__(16) int ring[STAGES][CHUNK][G];
  __shared__ int top[G];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);    // utterances of this block
  const int b = b0 + w;
  const size_t base = (size_t)b * smax;
  // a frame's G entry frames as two 16-byte copies
  const bool vec = nb == G && (B & 3) == 0 && ((uintptr_t)ent & 15) == 0;

  // the row's walk, the same in every lane of its warp
  int ro = 0, f0 = 0, end = 0;
  if (w < nb) {
    ro = row_offset ? row_offset[b] : 0;
    f0 = frame0 ? max(frame0[b] - ro, 0) : 0;
    end = n_frames[b];
  }
  bool active = w < nb && end > f0;
  int t = min(end - 1, T - 1);
  if (lane == 0) top[w] = active ? t : -1;
  int k = 0;
  int k_flushed = 0;                // segments below it are gathered
  int my_t = 0, my_st = 0;          // segment k_flushed + lane
  int g_k0 = -1, g_st = 0;          // the 32 before: gathered, not stored
  int8_t g_phn = 0;
  float g_al = 0.0f;
  bool written = w >= nb;

  // frames [c * CHUNK, +CHUNK) of the block's columns into c's stage (an
  // empty group for c < 0, so every thread commits one group a chunk)
  auto fetch_chunk = [&](int c) {
    if (c >= 0) {
      int(*s)[G] = ring[c % STAGES];
      const int lo = c * CHUNK;
      const int nf = min(CHUNK, T - lo);
      const int* src = ent + (size_t)lo * B + b0;
      if (vec) {
        for (int i = threadIdx.x; i < 2 * nf; i += G * 32)
          cp_async16(&s[i >> 1][(i & 1) * 4],
                     src + (size_t)(i >> 1) * B + (i & 1) * 4);
      } else {
        for (int i = threadIdx.x; i < nf * G; i += G * 32)
          if (i % G < nb)
            cp_async4(&s[i / G][i % G], src + (size_t)(i / G) * B + i % G);
      }
    }
    cp_async_commit();
  };

  // store the 32 segments gathered at the last flush, [g_k0, +32); then
  // gather the full buffer [k_flushed, +32), to store at the next flush
  auto store_gathered = [&]() {
    if (g_k0 >= 0) {
      const size_t o = base + g_k0 + lane;
      phn[o] = g_phn;
      start[o] = (StartT)g_st;
      alpha_end[o] = g_al;
    }
  };
  auto flush = [&]() {
    store_gathered();
    const size_t h = (size_t)my_t * B + b;
    g_phn = max_phn[h];
    g_al = alpha[h];
    g_st = my_st;
    g_k0 = k_flushed;
    k_flushed += 32;
  };
  // one hop: frame t's entry frame is e
  auto hop = [&](int e) {
    const int st = max(e - ro, f0);
    if (lane == k - k_flushed) {
      my_t = t;
      my_st = st;
    }
    ++k;
    end = st;
    t = min(end - 1, T - 1);
  };
  auto finish = [&]() {
    store_gathered();
    if (lane < k - k_flushed) {
      const size_t h = (size_t)my_t * B + b;
      const size_t o = base + k_flushed + lane;
      phn[o] = max_phn[h];
      start[o] = (StartT)my_st;
      alpha_end[o] = alpha[h];
    }
    if (lane == 0) count[b] = k;
    const int rest = smax - k;
    zero_bytes(reinterpret_cast<char*>(phn + base + k), rest, lane);
    zero_bytes(reinterpret_cast<char*>(start + base + k),
               rest * (int)sizeof(StartT), lane);
    zero_bytes(reinterpret_cast<char*>(alpha_end + base + k), rest * 4, lane);
    written = true;
  };

  __syncthreads();
  int t_top = -1;
  for (int i = 0; i < G; ++i) t_top = max(t_top, top[i]);
  const int c_top = t_top / CHUNK;   // -1 / CHUNK == 0, but then no loop
  if (t_top >= 0)
    for (int i = 0; i < STAGES - 1; ++i) fetch_chunk(c_top - i);
  for (int c = c_top; t_top >= 0 && c >= 0; --c) {
    cp_async_wait<STAGES - 2>();      // chunk c has landed, for this thread
    if (!__syncthreads_or(active)) break;   // ... for every thread
    fetch_chunk(c - (STAGES - 1));    // into chunk c + 1's stage, now free
    const int lo = c * CHUNK, hi = lo + CHUNK;
    const int* col = &ring[c % STAGES][0][w];   // frame lo + i at i * G
    while (active) {
      // hops inside the stage, up to a full buffer, on shared memory only
      const int k_end = min(k_flushed + 32, smax);
      while (k < k_end && end > f0 && t >= lo && t < hi)
        hop(col[(t - lo) * G]);
      if (k == k_flushed + 32) flush();
      active = k < smax && end > f0;
      if (!active || t < lo) break;
      // a hop that went forward (no History of a scan has one): device
      // memory
      if (t >= hi) hop(ent[(size_t)t * B + b]);
    }
    if (!active && !written) finish();
  }
  if (!written) finish();
  cp_async_wait<0>();
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
  const unsigned blocks = (unsigned)((B + G - 1) / G);
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
    backtrack_kernel<int16_t><<<blocks, G * 32, 0, s>>>(
        mp, en, al, nf, f0, ro, T, B, smax, ct, ph, static_cast<int16_t*>(start), ae);
  else
    backtrack_kernel<int><<<blocks, G * 32, 0, s>>>(
        mp, en, al, nf, f0, ro, T, B, smax, ct, ph, static_cast<int*>(start), ae);
  return cudaGetLastError();
}
