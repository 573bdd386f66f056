// Kernel G: the edge-list network Viterbi scan over T frames for B rows,
// for sm_90a.
//
// Replaces: phnrec_tpu/decoder/stknet.py::NetworkDecoder._step_fn and
// scan_block (:451-542), one ViterbiStep per frame as a lax.scan, vmapped
// over utterances in _scan_batch (:659-666); it has no Pallas twin.  Per
// row b and frame i (time t = t0[b] + 1 + i, valid while t <= n_valid[b]),
// with dmax(v, rows) the per-destination maximum over a dense incoming-edge
// row and the edge id of the FIRST slot holding it (a -1 pad reads NEG):
//
//   src[k]     = in_entry[k] ? entry[in_src_m[k]] : alpha[in_src_s[k]]
//   na, in_am  = dmax(src + in_w, in_dense);  na += obs[t]
//   nwt[e]     = word time of edge clip(in_am[e], 0, n_in - 1)
//   thresh     = max(na) - beam;  na' = na >= thresh ? na : NEG
//   xv, ex_am  = dmax(na'[ex_src] + ex_w, ex_dense)
//   xwt[m]     = nwt[ex_src[clip(ex_am[m], 0, n_ex - 1)]]
//   ne, cm_am  = dmax(cm_src < 0 ? NEG : xv[cm_src] + cm_w, cm_dense)
//   ne' = ne >= thresh ? ne : NEG;  c = clip(cm_am, 0, n_cm - 1)
//   newt       = cm_reset[c] ? t : xwt[max(cm_src[c], 0)]
//   sink_val, cs_am = dmax(cs_src < 0 ? NEG : xv[cs_src] + cs_w, cs_dense)
//   sink_wt    = xwt[max(cs_src[clip(cs_am, 0, n_cs - 1)], 0)]
//   (no sink edges: sink_val NEG, cs_am 0, sink_wt 0)
//
// records per frame: in_am, ex_am, cm_am, the OLD entry_edge and entry
// value, sink_val, cs_am, sink_wt, exit_val; where valid the carry becomes
// (na', nwt, ne', c, newt).  Adds, compares and selects only, compiled
// without fast math: equal to the plain version (ops/netscan.py) in every
// record, float bits included.
//
// What bounds it on the H100: not bytes.  A frame of the CZ phoneme loop
// reads 138 observations and writes 371 record words a row (B 256 x T 500
// moves ~261 MB, 0.078 ms at 3.35 TB/s), but a frame is a chain of three
// phases, each a max over dense rows (K_in 2, K_ex 1, K_cm 47, K_cs 46 at
// the CZ loop) that needs the phase before: the latency of one row's
// frames, repeated T times, is the time, and B 1 costs nearly what B 256
// does.
//
// The closure's and the sinks' rows are reduced once for each DISTINCT
// row (ops/netscan.distinct_rows: rows equal as sequences of (source,
// weight bits), length included, take the same first maximum at the same
// slot whatever their edge ids; the CZ loop's 46 entry rows are one), and
// each destination then reads its own edge id and word-time source at
// the winning slot from a per-destination table.  Exact: rows that differ
// in a source, a weight, a START edge's slot or their length stay apart.
//
// Two instances, picked by the network's sizes (ops/netscan.plan_instance
// holds the same limits):
// * The warp instance: a warp a row, up to W_ROWS rows a block sharing
//   the staged per-destination table, as many blocks as the SMs take at
//   B.  Limits: E <= 256 (8 states a lane), K_in and K_ex <= 4, M <= 64,
//   M + S <= 96, U <= 32 distinct rows with a lane's strided share of its
//   row <= 24 slots, the table beside one row's slice in shared memory.
//   Each lane holds its states' in-model slots and its models' exit slots
//   (source, weight, edge id, word-time source; the slot count a template
//   parameter, 2 or 4, so the compares are straight-line code) and its
//   share of one distinct row in registers across the frames; the states'
//   values sit in the warp's slice of shared memory (a slot reads any
//   state); the next frame's observations come into the slice by
//   cp.async, each lane its own states'; the beam max is one redux on the
//   floats' ordered integer keys; the G lanes of a distinct row merge its
//   first maximum by shuffles and each destination takes it from the
//   row's first lane; three __syncwarp a frame and no block barrier.
// * The block instance, every other network (the 1,500-model random net,
//   300-keyword KWS nets): a block of 256 threads a row, four barriers a
//   frame.  A group of L lanes takes an in-model or exit destination (L
//   from the row's width), each lane a strided share of its slots, then
//   a shuffle reduction keeping the larger value and, on equal values,
//   the smaller slot: the first maximum, as JAX's argmax; the distinct
//   rows take G lanes each.  The slots, the carry and the frame's values
//   live in shared memory, and the next frame's observations are copied
//   in by cp.async while a frame runs, where they fit (up to 227 KB);
//   otherwise the values sit in a per-row scratch in device memory and
//   the tables and observations are read from device memory (both held
//   to the plain version).  The kernel is a template on the two, and the
//   staged tables' pointers are offsets from the shared array, so every
//   access's memory space is known (a pointer aligned through an integer
//   made every slot read two generic 32-bit loads).
//
// Measured (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W; CZ loop, T 500,
// held, clocks a frame at B 256 / B 1; devtools/netscan_variants.py in
// turns): the first kernel, a thread per destination, ~25,200; the block
// design with every closure and sink row reduced, 6,258 / 5,280; the
// closure over distinct rows, 5,082-5,084 / 4,630-4,664; the first warp
// instance (the winners' ids read from staged slot tables, a loop break
// at each row's K, the next frame's observations loaded into registers)
// 3,106-3,129 / 3,089-3,113; the winners' ids and word-time sources in
// registers, no breaks, 3,252 / 2,687 (the register prefetch's load then
// stalled a row at B 132 and up); the observations by cp.async, 2,267 /
// 2,252.  Lost: the records and observations through pointers advanced a
// frame at a time (3,869 / 3,314); the shuffle rounds unrolled (3,853 /
// 3,282); cp.async observations alone (3,213 / 3,198).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "netdense.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;   // 227 KB, the H100's per-block opt-in

// a slot: x source index, y edge id (-1: pad), z word-time source (-1:
// reset to t), w the weight's bits
struct Tab {
  const int4* slot;    // [D * K]
  int D, K, L;         // destinations, slots a row, lanes a destination
};

// the closure's and the sinks' distinct rows: a slot (source index, the
// weight's bits) by row, each row's length, each destination's row, and
// each destination's (edge id, word-time source) by slot
struct Rows {
  const int2* row;     // [U * Kx]
  const int* len;      // [U]
  const int* of;       // [D]
  const int2* dst;     // [D * Kx]
  int U, Kx, G;        // distinct rows, slots a row, lanes a row
};

struct Net {
  int E, M, S, n_cs;
  Tab in, ex;
  Rows cx;
};

struct Carry {
  float* alpha;
  int* wt;
  float* entry;
  int* entry_edge;
  int* entry_wt;
};

struct Records {
  int* in_am;
  int* ex_am;
  int* cm_am;
  int* entry_edge;
  float* entry_val;
  float* sink_val;
  int* cs_am;
  int* sink_wt;
  float* exit_val;
};

// 4-byte words of a row's values: vin [M + E + 1], win [M + E], na [E + 1],
// nwt [E], xv [M + 1], xwt [M], eedge [M], then each distinct row's best
// value and slot, uv [U], uk [U]
__host__ __device__ inline int value_words(int E, int M, int U) {
  return 4 * E + 5 * M + 3 + 2 * U;
}

// bytes of the tables in shared memory: the in-model and exit slots (16
// bytes), the distinct rows' and the destinations' slots (8), the rows'
// lengths and the destinations' rows (4)
__host__ __device__ inline size_t table_bytes(int E, int M, int D, int Kin,
                                              int Kex, int Kx, int U) {
  return 16 * ((size_t)E * Kin + (size_t)M * Kex) +
         8 * ((size_t)U + D) * Kx + 4 * ((size_t)U + D);
}

// 4-byte words before the staged tables: the values, two frames of
// observations, rounded up to 16 bytes
__host__ __device__ inline int table_offset(int E, int M, int U) {
  return (value_words(E, M, U) + 2 * E + 3) / 4 * 4;
}

// the values, two frames of observations, then the tables
__host__ __device__ inline size_t smem_bytes(int E, int M, int D, int Kin,
                                             int Kex, int Kx, int U) {
  return 4 * (size_t)table_offset(E, M, U) +
         table_bytes(E, M, D, Kin, Kex, Kx, U);
}

__device__ __forceinline__ float pruned(float v, float thresh) {
  return v >= thresh ? v : NEG;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The first maximum of one destination's row, by the L lanes of a group
// (aligned within its warp); every lane of the group returns the value
// and the slot.  A lane starts at its first slot, so a row whose values
// are all -inf still yields its slot 0, as argmax does.
template <class Val>
__device__ __forceinline__ void group_max(const int4* slot, int K, int L,
                                          int gl, unsigned mask, Val val,
                                          float& best, int& bj) {
  best = -INFINITY;
  bj = 0x7fffffff;
#pragma unroll 4
  for (int j = gl; j < K; j += L) {
    const int4 sl = slot[j];
    const float v = val(sl.x) + __int_as_float(sl.w);
    if (bj == 0x7fffffff || v > best) {
      best = v;
      bj = j;
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(mask, best, off);
    const int oj = __shfl_xor_sync(mask, bj, off);
    if (ov > best || (ov == best && oj < bj)) {
      best = ov;
      bj = oj;
    }
  }
}

// The first maximum of a distinct row (len slots of (source, weight bits)
// over the exit values xv), by the G lanes of a group, as group_max.
__device__ __forceinline__ void row_max(const int2* slot, int len, int G,
                                        int gl, unsigned mask,
                                        const float* xv, float& best,
                                        int& bj) {
  best = -INFINITY;
  bj = 0x7fffffff;
#pragma unroll 4
  for (int j = gl; j < len; j += G) {
    const int2 sl = slot[j];
    const float v = xv[sl.x] + __int_as_float(sl.y);
    if (bj == 0x7fffffff || v > best) {
      best = v;
      bj = j;
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(mask, best, off);
    const int oj = __shfl_xor_sync(mask, bj, off);
    if (ov > best || (ov == best && oj < bj)) {
      best = ov;
      bj = oj;
    }
  }
}

__device__ __forceinline__ unsigned group_mask(int L, int lane) {
  return L == 32 ? 0xffffffffu : (((1u << L) - 1u) << (lane & ~(L - 1)));
}

// copy n elements to shared memory at p, the block's threads together
template <class X>
__device__ __forceinline__ void stage(X* p, const X* src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) p[i] = src[i];
}

// SMEM: the values, observations and tables in shared memory (a template
// parameter, so the compiler sees the address space of every access and
// may reorder them around the record stores); else in device memory.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
netscan_kernel(Net net, int T, const float* __restrict__ obs,
               const int* __restrict__ t0, const int* __restrict__ n_valid,
               const float* __restrict__ beam, Carry in, Carry out,
               Records rec, float* scratch) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_max[THREADS / 32];
  const int E = net.E, M = net.M, S = net.S;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const Rows& cx = net.cx;
  const int U = cx.U, Kx = cx.Kx, D = M + S;

  float* base = SMEM ? smem : scratch + (size_t)b * value_words(E, M, U);
  float* vin = base;                                  // [entry | alpha | NEG]
  int* win = reinterpret_cast<int*>(vin + M + E + 1); // [entry_wt | wt]
  float* na = reinterpret_cast<float*>(win + M + E);  // [new alpha | NEG]
  int* nwt = reinterpret_cast<int*>(na + E + 1);
  float* xv = reinterpret_cast<float*>(nwt + E);      // [exit values | NEG]
  int* xwt = reinterpret_cast<int*>(xv + M + 1);
  int* eedge = xwt + M;
  float* uv = reinterpret_cast<float*>(eedge + M);    // [U] distinct rows
  int* uk = reinterpret_cast<int*>(uv + U);
  float* obs_s = reinterpret_cast<float*>(uk + U);    // [2][E], smem only

  // the tables: staged into shared memory, or read where they are.  The
  // pointers are chosen by the template parameter and offset from the
  // shared array itself, so on the shared path the compiler sees
  // shared-memory pointers (a pointer reassigned in the tables' struct,
  // or aligned through an integer, stays generic: 32-bit generic loads
  // of single fields).
  const Tab &tin = net.in, &tex = net.ex;
  int4* staged = reinterpret_cast<int4*>(smem + table_offset(E, M, U));
  const size_t n_in = (size_t)tin.D * tin.K, n_ex = (size_t)tex.D * tex.K;
  int2* staged_rows = reinterpret_cast<int2*>(staged + n_in + n_ex);
  const int4* s_in = SMEM ? staged : tin.slot;
  const int4* s_ex = SMEM ? staged + n_in : tex.slot;
  const int2* s_row = SMEM ? staged_rows : cx.row;
  const int2* s_dst = SMEM ? staged_rows + (size_t)U * Kx : cx.dst;
  int* staged_len =
      reinterpret_cast<int*>(staged_rows + (size_t)(U + D) * Kx);
  const int* s_len = SMEM ? staged_len : cx.len;
  const int* s_of = SMEM ? staged_len + U : cx.of;
  if (SMEM) {
    stage(staged, tin.slot, n_in);
    stage(staged + n_in, tex.slot, n_ex);
    stage(staged_rows, cx.row, (size_t)U * Kx);
    stage(staged_rows + (size_t)U * Kx, cx.dst, (size_t)D * Kx);
    stage(staged_len, cx.len, (size_t)U);
    stage(staged_len + U, cx.of, (size_t)D);
  }
  for (int e = tid; e < E; e += THREADS) {
    vin[M + e] = in.alpha[(size_t)b * E + e];
    win[M + e] = in.wt[(size_t)b * E + e];
  }
  for (int m = tid; m < M; m += THREADS) {
    vin[m] = in.entry[(size_t)b * M + m];
    win[m] = in.entry_wt[(size_t)b * M + m];
    eedge[m] = in.entry_edge[(size_t)b * M + m];
  }
  if (tid == 0) {
    vin[M + E] = NEG;
    na[E] = NEG;
    xv[M] = NEG;
  }
  const float* orow = obs + (size_t)b * T * E;
  if (SMEM && T > 0) {
    for (int e = tid; e < E; e += THREADS) cp_async4(obs_s + e, orow + e);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  const int tb = t0[b], nv = n_valid[b];
  const float bm = beam[b];
  for (int i = 0; i < T; ++i) {
    const int t = tb + 1 + i;
    const bool valid = t <= nv;
    const size_t fr = (size_t)b * T + i;
    const float* o = SMEM ? obs_s + (i & 1) * E : orow + (size_t)i * E;
    if (SMEM && i + 1 < T) {
      float* nxt = obs_s + ((i + 1) & 1) * E;
      for (int e = tid; e < E; e += THREADS)
        cp_async4(nxt + e, orow + (size_t)(i + 1) * E + e);
      cp_async_commit();
    }

    // phase 1: in-model and entry edges into every state, + observation
    float lmax = -INFINITY;
    {
      const int L = tin.L, gl = lane & (L - 1), groups = THREADS / L;
      const unsigned mask = group_mask(L, lane);
      for (int e0 = 0; e0 < E; e0 += groups) {
        const int e = e0 + tid / L;
        if (e0 + (warp * 32) / L >= E) break;   // the warp's groups all past E
        float best;
        int bj;
        const int ee = e < E ? e : E - 1;
        const int4* sl = s_in + (size_t)ee * tin.K;
        group_max(sl, tin.K, L, gl, mask, [&](int s) { return vin[s]; },
                  best, bj);
        if (e < E && gl == 0) {
          const int4 sj = sl[bj];
          nwt[e] = win[sj.z];
          const float a = best + o[e];
          na[e] = a;
          rec.in_am[fr * E + e] = sj.y;
          lmax = fmaxf(lmax, a);
        }
      }
    }
    for (int m = tid; m < M; m += THREADS) {
      rec.entry_edge[fr * M + m] = eedge[m];
      rec.entry_val[fr * M + m] = vin[m];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    if (lane == 0) warp_max[warp] = lmax;
    __syncthreads();
    float mx = lane < THREADS / 32 ? warp_max[lane] : -INFINITY;
#pragma unroll
    for (int off = THREADS / 64; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float thresh = __shfl_sync(0xffffffffu, mx, 0) - bm;

    // phase 2: exits from the cut alpha
    {
      const int L = tex.L, gl = lane & (L - 1), groups = THREADS / L;
      const unsigned mask = group_mask(L, lane);
      for (int m0 = 0; m0 < M; m0 += groups) {
        const int m = m0 + tid / L;
        if (m0 + (warp * 32) / L >= M) break;
        float best;
        int bj;
        const int mm = m < M ? m : M - 1;
        const int4* sl = s_ex + (size_t)mm * tex.K;
        group_max(sl, tex.K, L, gl, mask,
                  [&](int s) { return pruned(na[s], thresh); }, best, bj);
        if (m < M && gl == 0) {
          const int4 sj = sl[bj];
          xv[m] = best;
          xwt[m] = nwt[sj.z];
          rec.ex_am[fr * M + m] = sj.y;
          rec.exit_val[fr * M + m] = best;
        }
      }
    }
    __syncthreads();

    // phase 3: the closure into the model entries and the sinks, first
    // the first maximum of each distinct row, G lanes a row
    {
      const int G = cx.G, gl = lane & (G - 1), groups = THREADS / G;
      const unsigned mask = group_mask(G, lane);
      for (int u0 = 0; u0 < U; u0 += groups) {
        const int u = u0 + tid / G;
        if (u0 + (warp * 32) / G >= U) break;
        const int uu = u < U ? u : U - 1;
        float best;
        int bj;
        row_max(s_row + (size_t)uu * Kx, s_len[uu], G, gl, mask, xv, best,
                bj);
        if (u < U && gl == 0) {
          uv[u] = best;
          uk[u] = bj;
        }
      }
    }
    __syncthreads();
    // then each destination reads its row's best and, at the winning
    // slot, its own edge id and word-time source
    for (int d = tid; d < D; d += THREADS) {
      if (d >= M && net.n_cs == 0) {  // no sink edges
        rec.sink_val[fr * S + d - M] = NEG;
        rec.cs_am[fr * S + d - M] = 0;
        rec.sink_wt[fr * S + d - M] = 0;
        continue;
      }
      const int u = s_of[d];
      const float best = uv[u];
      const int2 iz = s_dst[(size_t)d * Kx + uk[u]];
      if (d < M) {
        rec.cm_am[fr * M + d] = iz.x;
        if (valid) {
          vin[d] = pruned(best, thresh);
          eedge[d] = iz.x > 0 ? iz.x : 0;
          win[d] = iz.y < 0 ? t : xwt[iz.y];
        }
      } else {
        rec.sink_val[fr * S + d - M] = best;
        rec.cs_am[fr * S + d - M] = iz.x;
        rec.sink_wt[fr * S + d - M] = xwt[iz.y];
      }
    }
    if (valid)
      for (int e = tid; e < E; e += THREADS) {
        vin[M + e] = pruned(na[e], thresh);
        win[M + e] = nwt[e];
      }
    if (SMEM) cp_async_wait_all();
    __syncthreads();
  }

  for (int e = tid; e < E; e += THREADS) {
    out.alpha[(size_t)b * E + e] = vin[M + e];
    out.wt[(size_t)b * E + e] = win[M + e];
  }
  for (int m = tid; m < M; m += THREADS) {
    out.entry[(size_t)b * M + m] = vin[m];
    out.entry_edge[(size_t)b * M + m] = eedge[m];
    out.entry_wt[(size_t)b * M + m] = win[m];
  }
}

// -- the warp instance: a warp a row --------------------------------------
//
// Limits (ops/netscan.py holds the same numbers; a network past any of
// them takes the block instance): E <= 32 x 8 states (EPL states a lane,
// state e = j * 32 + lane), K_in and K_ex <= W_K slots (KM: 2 or W_K, a
// template parameter), M <= 32 x W_MPL
// models, M + S <= 32 x W_DPL destinations, U <= 32 distinct closure /
// sink rows and a lane's share of its row (ceil(Kx / G) strided slots,
// G lanes a row) <= W_CR, and the staged tables beside one row's slice
// within a block's shared memory.
constexpr int W_K = 4;
constexpr int W_MPL = 2;
constexpr int W_DPL = 3;
constexpr int W_CR = 24;
constexpr int W_ROWS = 4;   // rows (warps) a block, at most

struct WarpArgs {
  const int4 *in_slot, *ex_slot;   // [E * Kin], [M * Kex]
  const int2* cx_row;              // [U * Kx]
  const int *cx_len, *cx_of;       // [U], [D]
  const int2* cx_dst;              // [D * Kx]
  const float* obs;                // [B, T, E]
  const int *t0, *n_valid;
  const float* beam;
  Carry in, out;
  Records rec;
  int B, T, E, M, S, n_cs, Kin, Kex, Kx, U, G, SG, rows;
};

// 4-byte words of a row's slice: vin [M + E + 1], win [M + E], na [E + 1],
// nwt [E], xv [M + 1], xwt [M], obs [2][E], rounded up to 16 bytes
__host__ __device__ inline int warp_slice_words(int E, int M) {
  return (6 * E + 4 * M + 3 + 3) / 4 * 4;
}

// bytes of the table a block stages: the destinations' (edge id,
// word-time source) by slot
__host__ __device__ inline size_t warp_table_bytes(int D, int Kx) {
  return 8 * (size_t)D * Kx;
}

template <int EPL, int KM>
__global__ void __launch_bounds__(32 * W_ROWS)
netscan_warp_kernel(const WarpArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int E = g.E, M = g.M, S = g.S, D = M + S, T = g.T;
  const int Kin = g.Kin, Kex = g.Kex, Kx = g.Kx, G = g.G, SG = g.SG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the block's table, then a slice a row
  int2* s_dst = reinterpret_cast<int2*>(smem);
  stage(s_dst, g.cx_dst, (size_t)D * Kx);
  const size_t tab_words = warp_table_bytes(D, Kx) / 4;
  float* vin = smem + tab_words + (size_t)warp * warp_slice_words(E, M);
  int* win = reinterpret_cast<int*>(vin + M + E + 1);  // [entry_wt | wt]
  float* na = reinterpret_cast<float*>(win + M + E);   // [cut alpha | NEG]
  int* nwt = reinterpret_cast<int*>(na + E + 1);
  float* xv = reinterpret_cast<float*>(nwt + E);       // [exit values | NEG]
  int* xwt = reinterpret_cast<int*>(xv + M + 1);
  float* obs_s = reinterpret_cast<float*>(xwt + M);     // [2][E]
  __syncthreads();  // the tables are read by every warp of the block
  const int b = blockIdx.x * g.rows + warp;
  if (b >= g.B) return;

  // the carry into the slice; each lane's own destinations' entry values
  // and edges also in registers (the records of the carry entering a
  // frame are stored from them)
  for (int e = lane; e < E; e += 32) {
    vin[M + e] = g.in.alpha[(size_t)b * E + e];
    win[M + e] = g.in.wt[(size_t)b * E + e];
  }
  for (int m = lane; m < M; m += 32) {
    vin[m] = g.in.entry[(size_t)b * M + m];
    win[m] = g.in.entry_wt[(size_t)b * M + m];
  }
  if (lane == 0) {
    vin[M + E] = NEG;
    na[E] = NEG;
    xv[M] = NEG;
  }
  float en[W_DPL];
  int eg[W_DPL], dof[W_DPL];
#pragma unroll
  for (int j = 0; j < W_DPL; ++j) {
    const int d = j * 32 + lane;
    en[j] = d < M ? g.in.entry[(size_t)b * M + d] : 0.f;
    eg[j] = d < M ? g.in.entry_edge[(size_t)b * M + d] : 0;
    dof[j] = d < D ? g.cx_of[d] : 0;
  }

  // each lane's slots, held in registers across the frames: its states'
  // in-model slots and its models' exit slots (source, weight, edge id,
  // word-time source; past a row's K the NEG sentinel with weight -inf,
  // which never wins a strict compare) and its share of one distinct row
  // (u = lane / G, strided slots j = lane % G + G * s)
  int isrc[EPL][KM], iid[EPL][KM], iz[EPL][KM];
  int xsrc[W_MPL][KM], xid[W_MPL][KM], xz[W_MPL][KM], csrc[W_CR];
  float iw[EPL][KM], xw[W_MPL][KM], cw[W_CR];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = j * 32 + lane;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int4 sl = e < E && k < Kin
                          ? g.in_slot[(size_t)e * Kin + k]
                          : make_int4(M + E, 0, 0, __float_as_int(-INFINITY));
      isrc[j][k] = sl.x;
      iid[j][k] = sl.y;
      iz[j][k] = sl.z;
      iw[j][k] = __int_as_float(sl.w);
    }
    // frame 0's observations, each lane its own states' (the lane
    // reads only what it copied: no barrier, only its own wait)
    if (e < E && T > 0) cp_async4(obs_s + e, g.obs + (size_t)b * T * E + e);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < W_MPL; ++j) {
    const int m = j * 32 + lane;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const int4 sl = m < M && k < Kex
                          ? g.ex_slot[(size_t)m * Kex + k]
                          : make_int4(E, 0, 0, __float_as_int(-INFINITY));
      xsrc[j][k] = sl.x;
      xid[j][k] = sl.y;
      xz[j][k] = sl.z;
      xw[j][k] = __int_as_float(sl.w);
    }
  }
  const int u = lane / G, gl = lane % G;
  const int clen = u < g.U ? g.cx_len[u] : 0;
#pragma unroll
  for (int s = 0; s < W_CR; ++s) {
    const int j = gl + G * s;
    const int2 sl = s < SG && j < clen ? g.cx_row[(size_t)u * Kx + j]
                                       : make_int2(M, 0);
    csrc[s] = sl.x;
    cw[s] = __int_as_float(sl.y);
  }
  __syncwarp();

  const int tb = g.t0[b], nv = g.n_valid[b];
  const float bm = g.beam[b];
  const Records& rec = g.rec;
  for (int i = 0; i < T; ++i) {
    const int t = tb + 1 + i;
    const bool valid = t <= nv;
    const size_t fr = (size_t)b * T + i;
    // this frame's observations are in; the next frame's are copied in
    // by cp.async while this one runs
    const float* ob = obs_s + (i & 1) * E;
    cp_async_wait_all();
    if (i + 1 < T) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = j * 32 + lane;
        if (e < E)
          cp_async4(obs_s + ((i + 1) & 1) * E + e,
                    g.obs + (fr + 1) * E + e);
      }
      cp_async_commit();
    }
#pragma unroll
    for (int j = 0; j < W_DPL; ++j) {
      const int d = j * 32 + lane;
      if (d < M) {
        rec.entry_edge[fr * M + d] = eg[j];
        rec.entry_val[fr * M + d] = en[j];
      }
    }

    // in-model and entry edges into the lane's states, + observation
    float a[EPL];
    int awt[EPL];
    float lmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = j * 32 + lane;
      float best = vin[isrc[j][0]] + iw[j][0];
      int id = iid[j][0], z = iz[j][0];
#pragma unroll
      for (int k = 1; k < KM; ++k) {
        const float v = vin[isrc[j][k]] + iw[j][k];
        if (v > best) {
          best = v;
          id = iid[j][k];
          z = iz[j][k];
        }
      }
      a[j] = best + ob[e < E ? e : E - 1];
      awt[j] = win[z];
      if (e < E) {
        rec.in_am[fr * E + e] = id;
        lmax = fmaxf(lmax, a[j]);
      }
    }
    // the beam against the row's best state
    const float thresh = netdense::warp_max(lmax) - bm;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = j * 32 + lane;
      a[j] = pruned(a[j], thresh);
      if (e < E) {
        na[e] = a[j];
        nwt[e] = awt[j];
      }
    }
    __syncwarp();

    // exits from the cut alpha
#pragma unroll
    for (int j = 0; j < W_MPL; ++j) {
      const int m = j * 32 + lane;
      float best = na[xsrc[j][0]] + xw[j][0];
      int id = xid[j][0], z = xz[j][0];
#pragma unroll
      for (int k = 1; k < KM; ++k) {
        const float v = na[xsrc[j][k]] + xw[j][k];
        if (v > best) {
          best = v;
          id = xid[j][k];
          z = xz[j][k];
        }
      }
      if (m < M) {
        xv[m] = best;
        xwt[m] = nwt[z];
        rec.ex_am[fr * M + m] = id;
        rec.exit_val[fr * M + m] = best;
      }
    }
    __syncwarp();

    // the closure and the sinks: the first maximum of each distinct row
    // by its G lanes (every lane of the group ends with it) ...
    float rv = -INFINITY;
    int rk = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < W_CR; ++s) {
      if (s >= SG) break;
      const float v = xv[csrc[s]] + cw[s];
      if (gl + G * s < clen && (rk == 0x7fffffff || v > rv)) {
        rv = v;
        rk = gl + G * s;
      }
    }
    for (int off = G >> 1; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv, off);
      const int ok = __shfl_xor_sync(0xffffffffu, rk, off);
      if (ov > rv || (ov == rv && ok < rk)) {
        rv = ov;
        rk = ok;
      }
    }
    // ... then each destination takes its row's from the row's first
    // lane, and its own edge id and word-time source at the winning slot
#pragma unroll
    for (int j = 0; j < W_DPL; ++j) {
      const int d = j * 32 + lane;
      const float v = __shfl_sync(0xffffffffu, rv, dof[j] * G);
      const int k = __shfl_sync(0xffffffffu, rk, dof[j] * G);
      if (d >= D) continue;
      if (d >= M && g.n_cs == 0) {  // no sink edges
        rec.sink_val[fr * S + d - M] = NEG;
        rec.cs_am[fr * S + d - M] = 0;
        rec.sink_wt[fr * S + d - M] = 0;
        continue;
      }
      const int2 iz = s_dst[d * Kx + k];
      if (d < M) {
        rec.cm_am[fr * M + d] = iz.x;
        if (valid) {
          en[j] = pruned(v, thresh);
          eg[j] = iz.x > 0 ? iz.x : 0;
          vin[d] = en[j];
          win[d] = iz.y < 0 ? t : xwt[iz.y];
        }
      } else {
        rec.sink_val[fr * S + d - M] = v;
        rec.cs_am[fr * S + d - M] = iz.x;
        rec.sink_wt[fr * S + d - M] = xwt[iz.y];
      }
    }
    if (valid) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = j * 32 + lane;
        if (e < E) {
          vin[M + e] = a[j];
          win[M + e] = awt[j];
        }
      }
    }
    __syncwarp();
  }

  for (int e = lane; e < E; e += 32) {
    g.out.alpha[(size_t)b * E + e] = vin[M + e];
    g.out.wt[(size_t)b * E + e] = win[M + e];
  }
#pragma unroll
  for (int j = 0; j < W_DPL; ++j) {
    const int d = j * 32 + lane;
    if (d < M) {
      g.out.entry[(size_t)b * M + d] = en[j];
      g.out.entry_edge[(size_t)b * M + d] = eg[j];
      g.out.entry_wt[(size_t)b * M + d] = win[d];
    }
  }
}

using WarpKernel = void (*)(const WarpArgs);

// the states-a-lane instances, E <= 32 x EPL, at KM slots a state
template <int KM>
WarpKernel warp_kernel_for(int E) {
  if (E <= 32) return netscan_warp_kernel<1, KM>;
  if (E <= 64) return netscan_warp_kernel<2, KM>;
  if (E <= 96) return netscan_warp_kernel<3, KM>;
  if (E <= 128) return netscan_warp_kernel<4, KM>;
  if (E <= 160) return netscan_warp_kernel<5, KM>;
  if (E <= 192) return netscan_warp_kernel<6, KM>;
  if (E <= 256) return netscan_warp_kernel<8, KM>;
  return nullptr;
}

// lanes a destination of a row of K slots: up to 12 slots a lane, <= 32
int lanes_for(int K) {
  int L = 1;
  while (L < 32 && (K + L - 1) / L > 12) L <<= 1;
  return L;
}

// lanes a distinct row of Kx slots when U rows share `threads` lanes: as
// many as leave every row a group (a power of two, <= 32, no more than
// the slots need)
int lanes_for_rows(int U, int Kx, int threads) {
  int G = 1;
  while (G < 32 && U * 2 * G <= threads && G < Kx) G <<= 1;
  return G;
}

// The warp instance's plan: rows a block (as many blocks as the SMs take
// at B, up to W_ROWS rows a block, as shared memory holds) and its
// dynamic shared memory; false when the network is past the instance's
// limits.
bool warp_plan(int B, int E, int M, int S, int Kin, int Kex, int Kx, int U,
               int* rows, size_t* smem) {
  const int G = lanes_for_rows(U, Kx, 32);
  if (E > 256 || Kin > W_K || Kex > W_K || M > 32 * W_MPL ||
      M + S > 32 * W_DPL || U > 32 || (Kx + G - 1) / G > W_CR)
    return false;
  int dev = 0, optin = 0, n_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t tab = warp_table_bytes(M + S, Kx);
  const size_t slice = 4 * (size_t)warp_slice_words(E, M);
  int w = (B + n_sm - 1) / n_sm;
  w = w < 1 ? 1 : (w > W_ROWS ? W_ROWS : w);
  while (w > 1 && tab + w * slice > (size_t)optin) --w;
  if (tab + slice > (size_t)optin) return false;
  *rows = w;
  *smem = tab + w * slice;
  return true;
}

int launch_warp(int B, int T, int E, int M, int S, int n_cs, int Kin,
                int Kex, int Kx, int U, const void* in_slot,
                const void* ex_slot, const void* cx_row, const void* cx_len,
                const void* cx_of, const void* cx_dst, const void* obs,
                const void* t0, const void* n_valid, const void* beam,
                void* alpha, void* wt, void* entry, void* entry_edge,
                void* entry_wt, void* alpha_out, void* wt_out,
                void* entry_out, void* entry_edge_out, void* entry_wt_out,
                void* in_am, void* ex_am, void* cm_am, void* r_entry_edge,
                void* entry_val, void* sink_val, void* cs_am, void* sink_wt,
                void* exit_val, void* stream) {
  int rows;
  size_t smem;
  const WarpKernel k = Kin <= 2 && Kex <= 2 ? warp_kernel_for<2>(E)
                                             : warp_kernel_for<W_K>(E);
  if (!k || !warp_plan(B, E, M, S, Kin, Kex, Kx, U, &rows, &smem))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  WarpArgs g;
  g.in_slot = static_cast<const int4*>(in_slot);
  g.ex_slot = static_cast<const int4*>(ex_slot);
  g.cx_row = static_cast<const int2*>(cx_row);
  g.cx_len = static_cast<const int*>(cx_len);
  g.cx_of = static_cast<const int*>(cx_of);
  g.cx_dst = static_cast<const int2*>(cx_dst);
  g.obs = static_cast<const float*>(obs);
  g.t0 = static_cast<const int*>(t0);
  g.n_valid = static_cast<const int*>(n_valid);
  g.beam = static_cast<const float*>(beam);
  g.in = Carry{static_cast<float*>(alpha), static_cast<int*>(wt),
               static_cast<float*>(entry), static_cast<int*>(entry_edge),
               static_cast<int*>(entry_wt)};
  g.out = Carry{static_cast<float*>(alpha_out), static_cast<int*>(wt_out),
                static_cast<float*>(entry_out),
                static_cast<int*>(entry_edge_out),
                static_cast<int*>(entry_wt_out)};
  g.rec = Records{static_cast<int*>(in_am), static_cast<int*>(ex_am),
                  static_cast<int*>(cm_am), static_cast<int*>(r_entry_edge),
                  static_cast<float*>(entry_val),
                  static_cast<float*>(sink_val), static_cast<int*>(cs_am),
                  static_cast<int*>(sink_wt), static_cast<float*>(exit_val)};
  g.B = B;
  g.T = T;
  g.E = E;
  g.M = M;
  g.S = S;
  g.n_cs = n_cs;
  g.Kin = Kin;
  g.Kex = Kex;
  g.Kx = Kx;
  g.U = U;
  g.G = lanes_for_rows(U, Kx, 32);
  g.SG = (Kx + g.G - 1) / g.G;
  g.rows = rows;
  k<<<(B + rows - 1) / rows, 32 * rows, smem,
      static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}

}  // namespace

// shared memory a block of the block instance needs to hold everything (0:
// more than it can)
extern "C" long long netscan_smem_bytes(int E, int M, int S, int Kin,
                                        int Kex, int Kx, int U) {
  const size_t n = smem_bytes(E, M, M + S, Kin, Kex, Kx, U);
  return n <= (size_t)SMEM_MAX ? (long long)n : 0;
}

// 4-byte words of a row's scratch in device memory when it does not fit
extern "C" int netscan_scratch_words(int E, int M, int U) {
  return value_words(E, M, U);
}

extern "C" int netscan(int B, int T, int E, int M, int S, int n_cs,
                       int Kin, int Kex, int Kx, int U,
                       const void* in_slot, const void* ex_slot,
                       const void* cx_row, const void* cx_len,
                       const void* cx_of, const void* cx_dst,
                       const void* obs, const void* t0, const void* n_valid,
                       const void* beam, void* alpha, void* wt, void* entry,
                       void* entry_edge, void* entry_wt, void* alpha_out,
                       void* wt_out, void* entry_out, void* entry_edge_out,
                       void* entry_wt_out, void* in_am, void* ex_am,
                       void* cm_am, void* r_entry_edge, void* entry_val,
                       void* sink_val, void* cs_am, void* sink_wt,
                       void* exit_val, void* scratch, int use_smem,
                       int warp, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T < 0 || E <= 0 || M <= 0 || S < 0 || n_cs < 0 || Kin <= 0 ||
      Kex <= 0 || Kx <= 0 || U <= 0)
    return cudaErrorInvalidValue;
  if (warp)
    return launch_warp(B, T, E, M, S, n_cs, Kin, Kex, Kx, U, in_slot,
                       ex_slot, cx_row, cx_len, cx_of, cx_dst, obs, t0,
                       n_valid, beam, alpha, wt, entry, entry_edge, entry_wt,
                       alpha_out, wt_out, entry_out, entry_edge_out,
                       entry_wt_out, in_am, ex_am, cm_am, r_entry_edge,
                       entry_val, sink_val, cs_am, sink_wt, exit_val,
                       stream);
  auto tab = [](const void* s, int D, int K) {
    return Tab{static_cast<const int4*>(s), D, K, lanes_for(K)};
  };
  Rows cx{static_cast<const int2*>(cx_row), static_cast<const int*>(cx_len),
          static_cast<const int*>(cx_of), static_cast<const int2*>(cx_dst),
          U, Kx, lanes_for_rows(U, Kx, THREADS)};
  Net net{E, M, S, n_cs, tab(in_slot, E, Kin), tab(ex_slot, M, Kex), cx};
  Carry cin{static_cast<float*>(alpha), static_cast<int*>(wt),
            static_cast<float*>(entry), static_cast<int*>(entry_edge),
            static_cast<int*>(entry_wt)};
  Carry cout{static_cast<float*>(alpha_out), static_cast<int*>(wt_out),
             static_cast<float*>(entry_out), static_cast<int*>(entry_edge_out),
             static_cast<int*>(entry_wt_out)};
  Records rec{static_cast<int*>(in_am),        static_cast<int*>(ex_am),
              static_cast<int*>(cm_am),        static_cast<int*>(r_entry_edge),
              static_cast<float*>(entry_val),  static_cast<float*>(sink_val),
              static_cast<int*>(cs_am),        static_cast<int*>(sink_wt),
              static_cast<float*>(exit_val)};
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<const float*>(obs);
  auto* tz = static_cast<const int*>(t0);
  auto* nv = static_cast<const int*>(n_valid);
  auto* bm = static_cast<const float*>(beam);
  if (!use_smem) {
    netscan_kernel<false><<<B, THREADS, 0, s>>>(
        net, T, o, tz, nv, bm, cin, cout, rec, static_cast<float*>(scratch));
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes(E, M, M + S, Kin, Kex, Kx, U);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        netscan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  netscan_kernel<true><<<B, THREADS, smem, s>>>(net, T, o, tz, nv, bm, cin,
                                                cout, rec, nullptr);
  return cudaGetLastError();
}
