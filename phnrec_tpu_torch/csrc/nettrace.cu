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
// values the walk discards can read one).  Loads the walk does not use
// are not made: a row that is not live, or an in-model hop, reads no
// closure record; the outputs are the plain version's (ops/nettrace.py).
//
// What bounds it on the H100: not bytes (a row reads one in_am word a
// frame and three more a crossing, and writes 8 bytes a frame) but the
// walk's chain: each step's load address depends on the last step's
// load, T steps a row.  First design: a thread per row, 32 rows a block
// (one warp: B 256 gives 8 blocks), so every block holds the latency of
// one chain.  The outputs of 32 frames of the warp's 32 rows are held in
// shared memory and stored a row at a time, 128 contiguous bytes a warp
// store (a thread storing its own row's frames touched a sector per
// store: 78-85% of the old phoneme-loop walk's time, PERF.md).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int ROWS = 32;   // rows a block, a lane each
constexpr int CH = 32;     // frames staged before a store

__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

__global__ void __launch_bounds__(ROWS)
nettrace_kernel(int B, int T, int E, int M, int S, int n_in, int n_ex, int n_cm,
                int n_cs, int ts, const int* __restrict__ in_am,
                const int* __restrict__ ex_am, const int* __restrict__ cm_am,
                const int* __restrict__ entry_edge,
                const float* __restrict__ entry_val,
                const float* __restrict__ sink_val,
                const int* __restrict__ cs_am, const int* __restrict__ n_valid,
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

}  // namespace

extern "C" int nettrace(int B, int T, int E, int M, int S, int n_in, int n_ex,
                        int n_cm, int n_cs, int terminal_sink,
                        const void* in_am, const void* ex_am,
                        const void* cm_am, const void* entry_edge,
                        const void* entry_val, const void* sink_val,
                        const void* cs_am, const void* n_valid,
                        const void* frame0, const void* in_entry,
                        const void* in_src_m, const void* in_src_s,
                        const void* cm_src, const void* ex_src,
                        const void* cs_src, void* ok, void* sink_edge,
                        void* sink_val_out, void* edges, void* vals,
                        void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T <= 0 || E <= 0 || M <= 0 || S <= 0 || n_in <= 0 || n_ex <= 0 ||
      n_cm <= 0 || n_cs < 0 || terminal_sink < 0 || terminal_sink >= S)
    return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + ROWS - 1) / ROWS);
  nettrace_kernel<<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      B, T, E, M, S, n_in, n_ex, n_cm, n_cs, terminal_sink,
      static_cast<const int*>(in_am), static_cast<const int*>(ex_am),
      static_cast<const int*>(cm_am), static_cast<const int*>(entry_edge),
      static_cast<const float*>(entry_val),
      static_cast<const float*>(sink_val), static_cast<const int*>(cs_am),
      static_cast<const int*>(n_valid), static_cast<const int*>(frame0),
      static_cast<const uint8_t*>(in_entry), static_cast<const int*>(in_src_m),
      static_cast<const int*>(in_src_s), static_cast<const int*>(cm_src),
      static_cast<const int*>(ex_src), static_cast<const int*>(cs_src),
      static_cast<uint8_t*>(ok), static_cast<int*>(sink_edge),
      static_cast<float*>(sink_val_out), static_cast<int*>(edges),
      static_cast<float*>(vals));
  return cudaGetLastError();
}
