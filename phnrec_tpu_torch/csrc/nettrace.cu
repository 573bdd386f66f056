// Kernel H: the device traceback over kernel G's records, for sm_90a.
//
// Replaces: phnrec_tpu/decoder/stknet.py::NetworkDecoder._traceback_batch
// (:668-746), a reverse lax.scan over frames vmapped over rows; it has no
// Pallas twin.  Per row b: from the terminal sink's closure edge at the
// last valid frame (ok = n_valid > 0 and its value > NEG/2), resume at the
// source model's exit state, then one frame a step backwards, t = T-1..0:
//
//   live  = active && t < n_valid && model >= 0
//   k     = in_am[t, state];  is_entry = in_entry[k]
//   in-model hop: state = in_src_s[k]
//   entry hop:    m = in_src_m[k]; ek = clip(t == 0 ? entry_edge[0, m]
//                 : cm_am[t-1, m], 0, n_cm - 1); model = cm_src[ek];
//                 state = ex_src[ex_am[max(t-1, 0), max(model, 0)]]
//   emitted at t: ek and entry_val[t, m] where crossed and t > frame0,
//                 else -1 and 0.0
//   active ends on a crossing from START (model < 0), at t == 0, and on a
//   crossing at or before frame0.
//
// A -1 record index wraps to the last entry as JAX's indexing does (only
// values the walk discards can read one).  The outputs are the plain
// version's (ops/nettrace.py) bit for bit.
//
// What bounds it on the H100: the walk's chain, each step's load address
// depending on the last step's load, T steps a row.  The first design (a
// thread per row, every record loaded from device memory where the walk
// needs it) paid one to three device-memory latencies a step: ~2,855
// clocks a step at the CZ stkint loop (PERF.md).  The loads do not have to
// wait for the walk: a row's records are contiguous over frames, so a
// frame's whole record row can be fetched before the walk knows its state.
//
// Design (nettrace_warp_kernel): a warp per row, two rows a block.
// * The network's tables sit in shared memory, loaded once a block: one
//   word an in-edge (an entry edge's source model with the top bit set,
//   else its source state), cm_src and ex_src.
// * The row's frames stream backwards, CH (<= 32) frames a stage, through
//   a cp.async ring of STAGES stages: the in_am rows [CH, E] and
//   entry_val rows [CH, M] of the chunk, the cm_am and ex_am rows
//   [CH, M] one frame earlier, each one contiguous span (16-byte copies,
//   the unaligned head and tail by 4-byte ones, the shared copy offset to
//   keep them aligned).  Only frames below n_valid are read, and no chunk
//   is issued after the walk ends.
// * Every lane runs the same walk on shared memory (broadcast loads), so
//   a step is a chain of a few shared loads; a chunk's outputs are held in
//   shared memory and stored coalesced, a lane a frame.  Frames past
//   n_valid and after the walk's end are filled with -1 / 0.0 without
//   loads.
// Measured (PERF.md, CZ stkint loop, B 256 x T 500): 372 clocks a step,
// 7.6x the first design; one row alone 307, so a row's own walk still
// bounds it, not the records streamed (E + 3M words a frame of a live row,
// 1.5 TB/s).  Tried and slower or no better: resolving each chunk's in_am
// words to table words by all lanes before the walk (531 clocks), the
// output stores without the lane-0 branch or the walk unrolled by 2
// (379), 4 stages of 16 frames (400), one warp a block (700: half the
// rows an SM).  Where the tables and one stage of a row do not
// fit a block's shared memory (E + 3M ~ 4,500 words or more), the first
// design runs (nettrace_global_kernel): a thread per row, 32 rows a block,
// only the loads the walk uses, outputs staged a row of 32 frames at a
// time and stored coalesced.
//
// Both kernels are templates on the record ids' type: int32 (kernel G's
// records) or int16 (kernel E's, and the serving window's when every id
// fits).  An int16 span is staged as 16-byte pieces too, its unaligned
// head and tail (fewer than 8 ids each) by the 4-byte words that hold them
// (cp.async copies no fewer than 4 bytes; a word's other half lies in the
// same 16-byte unit, and lands in the span's slack).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int ROWS = 32;   // device-memory path: rows a block, a lane each
constexpr int CH = 32;     // device-memory path: frames staged before a store
constexpr int STAGES = 3;  // shared path: ring stages a warp
constexpr int CH_MAX = 32; // shared path: frames a stage, at most (a lane each)
constexpr size_t SMEM_MAX = 232448;
constexpr unsigned ENTRY = 0x80000000u;   // the table word of an entry edge

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

template <typename IdT>
__global__ void __launch_bounds__(ROWS)
nettrace_global_kernel(int B, int T, int E, int M, int S, int n_in, int n_ex, int n_cm,
                int n_cs, int ts, const IdT* __restrict__ in_am,
                const IdT* __restrict__ ex_am, const IdT* __restrict__ cm_am,
                const IdT* __restrict__ entry_edge,
                const float* __restrict__ entry_val,
                const float* __restrict__ sink_val,
                const IdT* __restrict__ cs_am, const int* __restrict__ n_valid,
                const int* __restrict__ frame0,
                const uint8_t* __restrict__ in_entry,
                const int* __restrict__ in_src_m,
                const int* __restrict__ in_src_s,
                const int* __restrict__ cm_src, const int* __restrict__ ex_src,
                const int* __restrict__ cs_src, uint8_t* ok_out,
                int* sink_edge_out, float* sink_val_out, int* edges,
                float* vals) {
  __shared__ int se[ROWS][CH + 1];
  __shared__ float sv[ROWS][CH + 1];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * ROWS, b = b0 + lane;
  const bool row = b < B;

  int nv = 0, f0 = -1, state = 0, model = -1;
  bool active = false;
  if (row) {
    nv = n_valid[b];
    f0 = frame0[b];
    int last = nv - 1 > 0 ? nv - 1 : 0;
    if (last > T - 1) last = T - 1;      // JAX clamps the index
    const size_t lr = (size_t)b * T + last;
    const int sink_edge = cs_am[lr * S + ts];
    const float sval = sink_val[lr * S + ts];
    const bool ok = nv > 0 && sval > NEG / 2;
    if (ok && n_cs > 0) {
      int e0 = sink_edge < 0 ? 0 : (sink_edge > n_cs - 1 ? n_cs - 1 : sink_edge);
      model = cs_src[e0];
    }
    if (model >= 0) state = ex_src[wrap(ex_am[lr * M + model], n_ex)];
    active = ok && model >= 0;
    ok_out[b] = ok;
    sink_edge_out[b] = sink_edge;
    sink_val_out[b] = sval;
  }
  const size_t rb = (size_t)b * T;
  const int n_chunks = (T + CH - 1) / CH;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int lo = c * CH, hi = lo + CH < T ? lo + CH : T;
    for (int t = hi - 1; t >= lo; --t) {
      int out_edge = -1;
      float out_val = 0.f;
      if (row && active && t < nv && model >= 0) {
        const int k = wrap(in_am[(rb + t) * E + state], n_in);
        if (in_entry[k]) {
          const int m = in_src_m[k];
          int ek = t == 0 ? entry_edge[rb * M + m]
                          : cm_am[(rb + t - 1) * M + m];
          ek = ek < 0 ? 0 : (ek > n_cm - 1 ? n_cm - 1 : ek);
          const int src_model = cm_src[ek];
          const int tm1 = t > 0 ? t - 1 : 0;
          const int src_c = src_model > 0 ? src_model : 0;
          state = ex_src[wrap(ex_am[(rb + tm1) * M + src_c], n_ex)];
          if (t > f0) {
            out_edge = ek;
            out_val = entry_val[(rb + t) * M + m];
          }
          model = src_model;
          if (src_model < 0 || t <= f0) active = false;
        } else {
          state = in_src_s[k];
        }
      }
      if (t == 0) active = false;
      se[lane][t - lo] = out_edge;
      sv[lane][t - lo] = out_val;
    }
    __syncwarp();
    // a row's frames of this chunk in one contiguous store of the warp
    for (int r = 0; r < ROWS && b0 + r < B; ++r)
      if (lo + lane < hi) {
        edges[(size_t)(b0 + r) * T + lo + lane] = se[r][lane];
        vals[(size_t)(b0 + r) * T + lo + lane] = sv[r][lane];
      }
    __syncwarp();
  }
}


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

// elements of T a 16-byte aligned span starts before `p`
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
               (16 / sizeof(T) - 1));
}

// elements of a staged span of n elements of T: room for its offset from
// 16 bytes, a whole number of 16-byte units
template <typename T>
__host__ __device__ constexpr int span_elems(int n) {
  return (n + 2 * (int)(16 / sizeof(T) - 1)) & ~(int)(16 / sizeof(T) - 1);
}

// words of one ring stage: the in_am span, then entry_val, cm_am, ex_am
template <typename IdT>
__host__ __device__ constexpr int stage_words(int ch, int E, int M) {
  return (span_elems<IdT>(ch * E) * (int)sizeof(IdT) +
          4 * span_elems<int>(ch * M) +
          2 * span_elems<IdT>(ch * M) * (int)sizeof(IdT)) / 4;
}

__host__ __device__ constexpr int table_words(int n_in, int n_cm, int n_ex) {
  return (n_in + n_cm + n_ex + 3) & ~3;
}

// the warp's copy of n words from src into the span at dst (at the
// source's offset from 16 bytes)
__device__ __forceinline__ void copy_span(int* dst, const int* src, int n,
                                          int lane) {
  const int mis = misalign(src);
  int* d = dst + mis;
  const int head = min((4 - mis) & 3, n);
  const int pieces = (n - head) >> 2;
  const int tail = n - head - 4 * pieces;
  for (int u = lane; u < pieces; u += 32)
    cp_async16(d + head + 4 * u, src + head + 4 * u);
  if (lane < head) cp_async4(d + lane, src + lane);
  if (lane < tail)
    cp_async4(d + head + 4 * pieces + lane, src + head + 4 * pieces + lane);
}

// the warp's copy of the 4-byte words that hold elements [lo, hi) of
// src (at most 8 elements, within one 16-byte unit) to the same offsets
// from d: the words' other halves are read inside that unit and written
// into the span's slack around its elements
__device__ __forceinline__ void copy_words(int16_t* d, const int16_t* src,
                                           int lo, int hi, int lane) {
  if (hi <= lo) return;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src + lo) & ~(uintptr_t)3;
  const uintptr_t e =
      (reinterpret_cast<uintptr_t>(src + hi) + 3) & ~(uintptr_t)3;
  const intptr_t shift = reinterpret_cast<const char*>(d) -
                         reinterpret_cast<const char*>(src);
  if (lane < (int)((e - a) >> 2))
    cp_async4(reinterpret_cast<char*>(a + 4 * lane) + shift,
              reinterpret_cast<const void*>(a + 4 * lane));
}

// the same for n 2-byte ids: 16-byte pieces, the unaligned head and tail
// by the 4-byte words that hold them
__device__ __forceinline__ void copy_span(int16_t* dst, const int16_t* src,
                                          int n, int lane) {
  const int mis = misalign(src);
  int16_t* d = dst + mis;
  const int head = min((8 - mis) & 7, n);
  const int pieces = (n - head) >> 3;
  for (int u = lane; u < pieces; u += 32)
    cp_async16(d + head + 8 * u, src + head + 8 * u);
  copy_words(d, src, 0, head, lane);
  copy_words(d, src, head + 8 * pieces, n, lane);
}

template <typename IdT>
struct Walk {
  int B, T, E, M, S, n_in, n_ex, n_cm, n_cs, ts;
  int ch;   // frames a stage
  const IdT *in_am, *ex_am, *cm_am, *entry_edge;
  const float *entry_val, *sink_val;
  const IdT* cs_am;
  const int *n_valid, *frame0;
  const uint8_t* in_entry;
  const int *in_src_m, *in_src_s, *cm_src, *ex_src, *cs_src;
  uint8_t* ok_out;
  int* sink_edge_out;
  float* sink_val_out;
  int* edges;
  float* vals;
};

template <typename IdT>
__global__ void __launch_bounds__(64) nettrace_warp_kernel(const Walk<IdT> w) {
  extern __shared__ __align__(16) int smem[];
  const int E = w.E, M = w.M, T = w.T, C = w.ch;
  int* tab = smem;                 // [n_in] in-edge words
  int* cmsrc = tab + w.n_in;       // [n_cm]
  int* exsrc = cmsrc + w.n_cm;     // [n_ex]
  for (int i = threadIdx.x; i < w.n_in; i += blockDim.x)
    tab[i] = w.in_entry[i] ? (int)(ENTRY | (unsigned)w.in_src_m[i])
                           : w.in_src_s[i];
  for (int i = threadIdx.x; i < w.n_cm; i += blockDim.x) cmsrc[i] = w.cm_src[i];
  for (int i = threadIdx.x; i < w.n_ex; i += blockDim.x) exsrc[i] = w.ex_src[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= w.B) return;  // the whole warp leaves together
  const int sw = stage_words<IdT>(C, E, M);
  int* ring = smem + table_words(w.n_in, w.n_cm, w.n_ex) +
              (size_t)warp * (STAGES * sw + 2 * CH_MAX);
  int* oe = ring + STAGES * sw;    // a chunk's outputs, a frame each
  float* ov = reinterpret_cast<float*>(oe + CH_MAX);

  // the start: every lane the same, from device memory
  const int nv = w.n_valid[b], f0 = w.frame0[b];
  const size_t rb = (size_t)b * T;
  int last = nv - 1 > 0 ? nv - 1 : 0;
  if (last > T - 1) last = T - 1;      // JAX clamps the index
  const size_t lr = rb + last;
  const int sink_edge = w.cs_am[lr * w.S + w.ts];
  const float sval = w.sink_val[lr * w.S + w.ts];
  const bool ok = nv > 0 && sval > NEG / 2;
  int model = -1, state = 0;
  if (ok && w.n_cs > 0) {
    const int e0 = sink_edge < 0 ? 0 : min(sink_edge, w.n_cs - 1);
    model = w.cs_src[e0];
  }
  if (model >= 0) state = exsrc[wrap(w.ex_am[lr * M + model], w.n_ex)];
  bool active = ok && model >= 0;
  if (lane == 0) {
    w.ok_out[b] = ok;
    w.sink_edge_out[b] = sink_edge;
    w.sink_val_out[b] = sval;
  }
  // frames the walk can use: below n_valid; the others -1 / 0.0
  const int top = active ? min(nv, T) : 0;
  for (int t = top + lane; t < T; t += 32) {
    w.edges[rb + t] = -1;
    w.vals[rb + t] = 0.0f;
  }
  const int nch = (top + C - 1) / C;

  // chunk c: frames [lo, hi), counted down from top; the cm / ex rows one
  // frame earlier (from frame 0 for the first chunk: frame 0 reads
  // entry_edge and ex_am's frame 0 from device memory)
  // a stage: the in_am span (ids), entry_val (words), cm_am, ex_am (ids)
  const int o_ev = span_elems<IdT>(C * E) * (int)sizeof(IdT) / 4;
  const int o_cm = o_ev + span_elems<int>(C * M);
  const int o_ex = o_cm + span_elems<IdT>(C * M) * (int)sizeof(IdT) / 4;
  auto issue = [&](int c) {
    const int hi = top - c * C, lo = max(hi - C, 0), clo = max(lo - 1, 0);
    int* st = ring + (c % STAGES) * sw;
    copy_span(reinterpret_cast<IdT*>(st), w.in_am + (rb + lo) * E,
              (hi - lo) * E, lane);
    copy_span(st + o_ev,
              reinterpret_cast<const int*>(w.entry_val) + (rb + lo) * M,
              (hi - lo) * M, lane);
    copy_span(reinterpret_cast<IdT*>(st + o_cm), w.cm_am + (rb + clo) * M,
              (hi - 1 - clo) * M, lane);
    copy_span(reinterpret_cast<IdT*>(st + o_ex), w.ex_am + (rb + clo) * M,
              (hi - 1 - clo) * M, lane);
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    __syncwarp();  // every lane is done with the stage chunk c+2 takes
    if (c + STAGES - 1 < nch) issue(c + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // chunk c has landed, for every lane
    __syncwarp();
    const int hi = top - c * C, lo = max(hi - C, 0), clo = max(lo - 1, 0);
    // frame t's rows at (t - lo) * width; its cm / ex rows (frame t - 1)
    // at (t - 1 - clo) * M
    const int* st = ring + (c % STAGES) * sw;
    const IdT* ins = reinterpret_cast<const IdT*>(st) +
                     misalign(w.in_am + (rb + lo) * E);
    const float* evs = reinterpret_cast<const float*>(st + o_ev) +
                       misalign(w.entry_val + (rb + lo) * M);
    const IdT* cms = reinterpret_cast<const IdT*>(st + o_cm) +
                     misalign(w.cm_am + (rb + clo) * M);
    const IdT* exs = reinterpret_cast<const IdT*>(st + o_ex) +
                     misalign(w.ex_am + (rb + clo) * M);
    for (int t = hi - 1; t >= lo; --t) {
      int out_edge = -1;
      float out_val = 0.f;
      if (active) {
        const int k = wrap(ins[(t - lo) * E + state], w.n_in);
        const int x = tab[k];
        if (x < 0) {
          const int m = x & 0x7fffffff;
          const int r = (t - 1 - clo) * M;
          int ek = t == 0 ? w.entry_edge[rb * M + m] : cms[r + m];
          ek = ek < 0 ? 0 : (ek > w.n_cm - 1 ? w.n_cm - 1 : ek);
          const int src_model = cmsrc[ek];
          const int src_c = src_model > 0 ? src_model : 0;
          const int ex = t == 0 ? w.ex_am[rb * M + src_c] : exs[r + src_c];
          state = exsrc[wrap(ex, w.n_ex)];
          if (t > f0) {
            out_edge = ek;
            out_val = evs[(t - lo) * M + m];
          }
          model = src_model;
          if (src_model < 0 || t <= f0) active = false;
        } else {
          state = x;
        }
      }
      if (t == 0) active = false;
      if (lane == 0) {
        oe[t - lo] = out_edge;
        ov[t - lo] = out_val;
      }
    }
    __syncwarp();
    if (lane < hi - lo) {
      w.edges[rb + lo + lane] = oe[lane];
      w.vals[rb + lo + lane] = ov[lane];
    }
    if (!active) {
      // the walk has ended: the frames below the chunk without loads
      for (int t = lane; t < lo; t += 32) {
        w.edges[rb + t] = -1;
        w.vals[rb + t] = 0.0f;
      }
      break;
    }
  }
  cp_async_wait<0>();   // no copy lands after the warp has left
}

// frames a stage of the shared path and its warps a block for a network
// (0 frames: the device-memory path)
template <typename IdT>
void plan(int E, int M, int n_in, int n_cm, int n_ex, int* ch, int* warps) {
  const size_t tw = table_words(n_in, n_cm, n_ex);
  for (int wp = 2; wp >= 1; --wp)
    for (int c = CH_MAX; c >= 4; c /= 2) {
      const size_t words =
          tw + (size_t)wp * (STAGES * (size_t)stage_words<IdT>(c, E, M) +
                             2 * CH_MAX);
      if (4 * words <= SMEM_MAX) {
        *ch = c;
        *warps = wp;
        return;
      }
    }
  *ch = 0;
  *warps = 0;
}

}  // namespace

namespace {

// the entry points' parameters: sizes, records, inputs, tables, outputs
#define NETTRACE_PARAMS                                                      \
  int B, int T, int E, int M, int S, int n_in, int n_ex, int n_cm, int n_cs, \
      int terminal_sink, const void *in_am, const void *ex_am,               \
      const void *cm_am, const void *entry_edge, const void *entry_val,      \
      const void *sink_val, const void *cs_am, const void *n_valid,          \
      const void *frame0, const void *in_entry, const void *in_src_m,        \
      const void *in_src_s, const void *cm_src, const void *ex_src,          \
      const void *cs_src, void *ok, void *sink_edge, void *sink_val_out,     \
      void *edges, void *vals, void *stream
#define NETTRACE_ARGS                                                        \
  B, T, E, M, S, n_in, n_ex, n_cm, n_cs, terminal_sink, in_am, ex_am, cm_am, \
      entry_edge, entry_val, sink_val, cs_am, n_valid, frame0, in_entry,     \
      in_src_m, in_src_s, cm_src, ex_src, cs_src, ok, sink_edge,             \
      sink_val_out, edges, vals, stream

template <typename IdT>
int trace(NETTRACE_PARAMS, bool force_global) {
  if (B <= 0) return cudaSuccess;
  if (T <= 0 || E <= 0 || M <= 0 || S <= 0 || n_in <= 0 || n_ex <= 0 ||
      n_cm <= 0 || n_cs < 0 || terminal_sink < 0 || terminal_sink >= S)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int ch = 0, warps = 0;
  if (!force_global) plan<IdT>(E, M, n_in, n_cm, n_ex, &ch, &warps);
  if (ch > 0) {
    const Walk<IdT> w{B, T, E, M, S, n_in, n_ex, n_cm, n_cs, terminal_sink, ch,
                 static_cast<const IdT*>(in_am), static_cast<const IdT*>(ex_am),
                 static_cast<const IdT*>(cm_am),
                 static_cast<const IdT*>(entry_edge),
                 static_cast<const float*>(entry_val),
                 static_cast<const float*>(sink_val),
                 static_cast<const IdT*>(cs_am),
                 static_cast<const int*>(n_valid),
                 static_cast<const int*>(frame0),
                 static_cast<const uint8_t*>(in_entry),
                 static_cast<const int*>(in_src_m),
                 static_cast<const int*>(in_src_s),
                 static_cast<const int*>(cm_src),
                 static_cast<const int*>(ex_src),
                 static_cast<const int*>(cs_src), static_cast<uint8_t*>(ok),
                 static_cast<int*>(sink_edge), static_cast<float*>(sink_val_out),
                 static_cast<int*>(edges), static_cast<float*>(vals)};
    const size_t smem =
        4 * (table_words(n_in, n_cm, n_ex) +
             (size_t)warps * (STAGES * (size_t)stage_words<IdT>(ch, E, M) +
                              2 * CH_MAX));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          nettrace_warp_kernel<IdT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    nettrace_warp_kernel<IdT><<<(unsigned)((B + warps - 1) / warps),
                                32 * warps, smem, st>>>(w);
    return cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((B + ROWS - 1) / ROWS);
  nettrace_global_kernel<IdT><<<blocks, ROWS, 0, st>>>(
      B, T, E, M, S, n_in, n_ex, n_cm, n_cs, terminal_sink,
      static_cast<const IdT*>(in_am), static_cast<const IdT*>(ex_am),
      static_cast<const IdT*>(cm_am), static_cast<const IdT*>(entry_edge),
      static_cast<const float*>(entry_val),
      static_cast<const float*>(sink_val), static_cast<const IdT*>(cs_am),
      static_cast<const int*>(n_valid), static_cast<const int*>(frame0),
      static_cast<const uint8_t*>(in_entry), static_cast<const int*>(in_src_m),
      static_cast<const int*>(in_src_s), static_cast<const int*>(cm_src),
      static_cast<const int*>(ex_src), static_cast<const int*>(cs_src),
      static_cast<uint8_t*>(ok), static_cast<int*>(sink_edge),
      static_cast<float*>(sink_val_out), static_cast<int*>(edges),
      static_cast<float*>(vals));
  return cudaGetLastError();
}

}  // namespace

// Frames a ring stage of the shared path for a network (E states, M
// models, its table sizes) with int32 records, 0 where it takes the
// device-memory path.
extern "C" int nettrace_stage_frames(int E, int M, int n_in, int n_cm,
                                     int n_ex) {
  int ch = 0, warps = 0;
  plan<int>(E, M, n_in, n_cm, n_ex, &ch, &warps);
  return ch;
}

// The walk of B rows over kernel G's records ([B, T, E] in_am; [B, T, M]
// ex_am, cm_am, entry_edge, entry_val; [B, T, S] sink_val, cs_am; ids
// int32), n_valid and frame0 [B], the network's tables; outputs ok,
// sink_edge, sink_val [B] and edges, vals [B, T].  Launches on `stream`,
// allocates nothing, does not synchronise.
extern "C" int nettrace(NETTRACE_PARAMS) {
  return trace<int>(NETTRACE_ARGS, false);
}

// The same on the device-memory path whatever the network (for checks).
extern "C" int nettrace_global(NETTRACE_PARAMS) {
  return trace<int>(NETTRACE_ARGS, true);
}

// The same two over records whose ids (in_am, ex_am, cm_am, entry_edge,
// cs_am) are int16, as kernel E and the serving window keep them.
extern "C" int nettrace_i16(NETTRACE_PARAMS) {
  return trace<int16_t>(NETTRACE_ARGS, false);
}

extern "C" int nettrace_global_i16(NETTRACE_PARAMS) {
  return trace<int16_t>(NETTRACE_ARGS, true);
}
