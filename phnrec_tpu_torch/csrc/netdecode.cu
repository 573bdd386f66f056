// Kernel E: the decode-mode dense network-Viterbi block over F frames for
// n streams, emitting the traceback records, for sm_90a.
//
// Replaces: phnrec_tpu/decoder/stknet.py::DenseKWSScan.step_decode
// (:961-996), scanned over a block's frames by MultiStreamStkDecode
// (phnrec_tpu/multistream.py:1357-1371); it has no Pallas twin.  Semantics
// per stream and frame (ViterbiStep on a uniform-S left-to-right network;
// E states, M models of S_M states each, S sinks), as kernel B
// (csrc/netstep.cu) computes them but with edge ids where B keeps word
// times:
//
//   records of the carry entering the frame: entry_val[m] = entry[m],
//             entry_edge[m] = the carried entry edge
//   in-model pass, state e of model m = e / S_M:
//     self  = alpha[e]   + w_self[e]
//     adv   = alpha[e-1] + w_adv[e]        (NEG weight at a model's first)
//     entry = entry[m]   + w_entry[e]      (NEG weight past the first)
//     a'[e] = best of (self, adv, entry), ties entry > adv > self (>=, the
//             first maximum over JAX's [entry rows, state rows] source
//             axis); in_am[e] = the winner's edge id (resolved on the host
//             per state and candidate); a'[e] += obs[e]
//   beam:   a' < max_e a' - beam  ->  NEG
//   exit:   x[m] = a'[(m+1)*S_M - 1] + w_exit[m]; ex_am[m] = that exit
//             edge's id (each model has one exit edge)
//   closure: entry'[m] = max over live edges r -> m of x[r] + A_cm[r, m],
//             sources ascending, strict-greater updates; cm_am[m] = the
//             winning edge's id, I_cm[r, m] (-1 where no edge is live);
//             below the beam threshold of the in-model best -> NEG; the
//             carried entry edge becomes cm_am[m]
//   sinks:  sink_val[s] = max over live edges r -> s of x[r] + A_cs[r, s],
//             cs_am[s] = I_cs[r, s]
//
// A frame f >= n_valid leaves the carry as it was (its records are still
// written).  Adds and compares only: values and ids are bit-equal to the
// plain version (ops/netdecode.py) wherever the value they belong to is
// live (> NEG / 2); dead entries hold other never-winning values and ids,
// as kernel B's do.  Records are [n, F, .], ids int16 or int32 (the
// caller's choice: int16 where every id table fits), -1 kept.
//
// What bounds it on the H100: the chain of dependent steps in a frame and
// the 512-odd dependent frames of a block (latency, far below the memory
// rate: ~1.3 kB of records a frame and stream at the CZ loop), and what a
// frame issues on one warp scheduler: the records' stores, the
// observations' copies, the closure.
//
// Design: one warp a stream (four a block), its states in registers
// (EPL a lane), each lane's three candidate edge ids in registers beside
// their weights, the in-model pass selecting the winner's id with its
// value, the beam max by redux (netdense.cuh), the tables staged in shared
// memory where they fit; each destination of the first 64 owns a lane
// (lane, lane + 32), which keeps its model's carried entry and entry edge
// and its exit id in registers and stores the records of the carry
// entering each frame at the frame's start; the observations come by
// cp.async, the warp's lanes side by side, three frames ahead in a ring
// of the warp's slice.  Two instances of the closure and the sinks, a
// template parameter the launch plan picks by the network's sizes:
// * redux (at most RED_COLUMNS distinct columns, 64 destinations and
//   RED_EPL states a lane; a phoneme loop's network): each column's first
//   maximum over the exits straight from registers, a lane's own exit
//   slots ascending (their edge weights into each column held in
//   registers) then the warp's by two reduxes, the largest value over the
//   floats' order-keeping ints and the smallest source holding it; each
//   destination picks its column's pair and looks its edge id up in an
//   [M + S][P] id table.  No shared round trip but the new entries.
// * general: the exits staged in the warp's slice, each distinct column's
//   best source over G lanes (kept in the lanes and fetched by shuffles
//   where the columns fit one round of the warp, else through shared
//   memory), then the destinations; past 64 destinations their carries in
//   the slice.
// The id type is a template parameter.
//
// Measured (PERF.md, CZ stkint loop, n 256 x F 512, int16 ids, NVIDIA
// H100 80GB HBM3, 700 W, devtools/netdecode_variants.py in turns with the
// source of commit 4eb19bd): the previous design, kernel B's with edge
// ids, 1,686-1,699 clocks a frame (held 0.436 ms; n 1 1,666): its
// closure's second pass ~560 clocks (the uv / uk round
// trip, divergent destinations, a branch on the next frame's carry
// records), the whole closure ~660, and at n 256 the next frame's
// observations loaded into registers mid-frame were waited on.  The
// carries in lanes and a cp.async ring (each lane its own states) 1,640;
// the redux closure as its own template instance (a frame loop of 7.1 KB
// of code against 25 KB with the wide networks' loops in it) 1,312 (a
// first cut whose columns' results sat in an indexed array went to local
// memory: 1,505; the observations back in registers: 1,949-1,994); the
// ring filled coalesced 1,273 (n 1 1,241, n 132 1,273, n 264 1,273).
// Staging in_am to store it coalesced was slower (1,671).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "netdense.cuh"

namespace {

using namespace netdense;

struct Args {
  const float* obs;      // [n, F, E]
  const float* alpha0;   // [n, E]
  const float* entry0;   // [n, M]
  const int* edge0;      // [n, M]
  const float *w_self, *w_adv, *w_entry;  // [E]
  const float* w_exit;   // [M]
  const int* id_in;      // [E][4]: the self, adv and entry edges' ids
  const int* id_exit;    // [M]
  const float* tab;      // [U_pad][P] distinct destination columns
  const int* col_of;     // [M + S]
  const int* ids;        // [M + S][P] edge id by destination and source
  const int* n_valid;    // [n]
  const float* beam;     // [n]
  int F, n, E, M, S, S_M, P, U;
  float* alpha_out;      // [n, E]
  float* entry_out;      // [n, M]
  int* edge_out;         // [n, M]
  void *in_am, *ex_am, *cm_am, *entry_edge, *cs_am;  // ids
  float *entry_val, *sink_val;
};

template <typename IdT>
__device__ __forceinline__ void put_id(void* p, size_t i, int v) {
  static_cast<IdT*>(p)[i] = (IdT)v;
}

constexpr int OBS_RING = 4;      // observation rows a warp keeps: 3 in flight
constexpr int RED_COLUMNS = 4;   // distinct columns the redux closure takes
constexpr int RED_EPL = 8;       // states a lane it takes (registers)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stream's observation row into a ring slot, the warp's lanes side
// by side (coalesced); the row is the warp's after every lane's wait and
// a __syncwarp.
template <int EPL>
__device__ __forceinline__ void fetch_obs(float* slot, const float* src,
                                          int E, int lane) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = 32 * j + lane;
    if (e < E) cp_async4(slot + e, src + e);
  }
}

// best_sources (netdense.cuh) where every distinct column fits one round
// of the warp (U << lg <= 32): nothing is stored, every lane of column
// u's group returns its best value and source.
__device__ __forceinline__ void best_in_lanes(const float* xv,
                                              const float* tab, int P,
                                              const ColumnSplit& c, int lane,
                                              float& v, int& k) {
  const int u = lane >> c.lg, g = lane & (c.G - 1);
  const float* t = tab + (size_t)u * P;
  v = NEG;
  k = -1;
  const int r1 = min(g * c.SG + c.SG, c.M4);
#pragma unroll 4
  for (int r = g * c.SG; r < r1; r += 4) {
    const float4 x = *reinterpret_cast<const float4*>(xv + r);
    const float4 p = *reinterpret_cast<const float4*>(t + r);
    take(v, k, x.x + p.x, r);
    take(v, k, x.y + p.y, r + 1);
    take(v, k, x.z + p.z, r + 2);
    take(v, k, x.w + p.w, r + 3);
  }
  for (int off = 1; off < c.G; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (ov > v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}

// The first maximum of the warp's (value, source) pairs, exactly as the
// ascending strict-greater walk from (NEG, -1) gives it: the largest value
// by one redux over the order-keeping ints, the smallest source holding
// it by another; (NEG, -1) where no value is above NEG.
__device__ __forceinline__ void warp_first_max(float v, int k, float& bv,
                                               int& bk) {
  const float m = warp_max(v);
  const int km = __reduce_min_sync(0xffffffffu, v == m ? k : 0x7fffffff);
  bv = m > NEG ? m : NEG;
  bk = m > NEG ? km : -1;
}

// One distinct column's first maximum over the warp's exits (the redux
// instance): each lane's exit slots ascending (x = the beamed value + the
// exit weight, + the slot's edge weight into the column), then
// warp_first_max; (NEG, -1) for a column past U (``on`` false).
template <int EPL>
__device__ __forceinline__ void redux_column(
    const float (&na)[EPL], const float (&wx)[EPL], const float (&tbu)[EPL],
    const int (&mo)[EPL], unsigned last, bool on, float& v, int& k) {
  float lv = NEG;
  int lk = -1;
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const float c = na[j] + wx[j] + tbu[j];
    const bool gt = (last >> j & 1) && c > lv;
    lv = gt ? c : lv;
    lk = gt ? mo[j] : lk;
  }
  v = NEG;
  k = -1;
  if (on) warp_first_max(lv, lk, v, k);
}

template <int EPL, bool SMEM_TAB, typename IdT, bool RED>
__global__ void __launch_bounds__(32 * MAX_STREAMS_PER_BLOCK)
net_decode_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  const int M = g.M, E = g.E, S = g.S, P = g.P, U = g.U, F = g.F, n = g.n;
  const int D = M + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int U_pad = (U + 31) / 32 * 32;
  // [U_pad][P] table, [D] column map and [D][P] ids (if staged), then per
  // warp: [P] exit value, [M] entry, [M] entry edge, [U] best value and
  // [U] best source of each column, the observation ring [OBS_RING][32 EPL]
  const size_t tab_floats =
      SMEM_TAB ? (size_t)U_pad * P + (D + 3) / 4 * 4 + (size_t)D * P : 0;
  const int head = P + (2 * M + 2 * U + 3) / 4 * 4;
  const int slice = head + OBS_RING * 32 * EPL;
  float* tab_s = smem;
  int* col_s = reinterpret_cast<int*>(smem + (size_t)U_pad * P);
  int* ids_s = col_s + (D + 3) / 4 * 4;
  float* xv = smem + tab_floats + (size_t)warp * slice;
  float* en = xv + P;
  int* eg = reinterpret_cast<int*>(en + M);
  float* uv = reinterpret_cast<float*>(eg + M);
  int* uk = reinterpret_cast<int*>(uv + U);
  float* ring = xv + head;

  if (SMEM_TAB) {
    const float4* src = reinterpret_cast<const float4*>(g.tab);
    float4* dst = reinterpret_cast<float4*>(tab_s);
    for (int i = threadIdx.x; i < U_pad * P / 4; i += blockDim.x)
      dst[i] = src[i];
    for (int i = threadIdx.x; i < D; i += blockDim.x) col_s[i] = g.col_of[i];
    for (int i = threadIdx.x; i < D * P; i += blockDim.x) ids_s[i] = g.ids[i];
  }
  __syncthreads();  // the tables are read by every warp of the block
  const float* tab = SMEM_TAB ? tab_s : g.tab;
  const int* col_of = SMEM_TAB ? col_s : g.col_of;
  const int* ids = SMEM_TAB ? ids_s : g.ids;
  const ColumnSplit cs = column_split(U, M);
  // (general instance) every distinct column's best in lanes where the
  // columns fit one round of the warp, else through uv / uk
  const bool one = (U << cs.lg) <= 32;

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;
  const int nv = g.n_valid[b];
  const float bm = g.beam[b];
  const size_t rb = (size_t)b * F;   // the stream's first record row

  // the first frames' observations, one commit group a row; the slots
  // past E read 0 (no copy writes them)
#pragma unroll
  for (int j = 0; j < EPL; ++j)
    if (32 * j + lane >= E)
      for (int i = 0; i < OBS_RING; ++i)
        ring[i * 32 * EPL + 32 * j + lane] = 0.f;
  for (int i = 0; i < OBS_RING - 1; ++i) {
    if (i < F)
      fetch_obs<EPL>(ring + i * 32 * EPL, g.obs + (rb + i) * E, E, lane);
    cp_async_commit();
  }

  float a[EPL], ws[EPL], wa[EPL], we[EPL], wx[EPL];
  int mo[EPL], id_self[EPL], id_adv[EPL], id_ent[EPL];
  // (redux instance) the edge weight from slot j's model into distinct
  // column u
  float tb[RED ? RED_COLUMNS : 1][RED ? EPL : 1];
  unsigned last = 0;  // bit j: slot j is its model's last state
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane * EPL + j;
    const bool in = e < E;
    a[j] = in ? g.alpha0[(size_t)b * E + e] : NEG;
    ws[j] = in ? g.w_self[e] : -INFINITY;
    wa[j] = in ? g.w_adv[e] : -INFINITY;
    we[j] = in ? g.w_entry[e] : -INFINITY;
    mo[j] = in ? e / g.S_M : 0;
    wx[j] = in ? g.w_exit[mo[j]] : 0.f;
    if (in && e % g.S_M == g.S_M - 1) last |= 1u << j;
    id_self[j] = in ? g.id_in[4 * e] : -1;
    id_adv[j] = in ? g.id_in[4 * e + 1] : -1;
    id_ent[j] = in ? g.id_in[4 * e + 2] : -1;
    if constexpr (RED) {
#pragma unroll
      for (int u = 0; u < RED_COLUMNS; ++u)
        tb[u][j] = u < U ? tab[u * P + mo[j]] : NEG;
    }
  }
  // destinations lane and lane + 32: their column, exit edge and (models)
  // carried entry and entry edge, in registers
  int cu[2], xid[2], eg_r[2];
  float en_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 32 * h + lane;
    cu[h] = d < D ? col_of[d] : 0;
    xid[h] = d < M ? g.id_exit[d] : -1;
    en_r[h] = d < M ? g.entry0[(size_t)b * M + d] : NEG;
    eg_r[h] = d < M ? g.edge0[(size_t)b * M + d] : -1;
  }
  for (int m = lane; m < M; m += 32) {
    en[m] = g.entry0[(size_t)b * M + m];
    eg[m] = g.edge0[(size_t)b * M + m];
  }
  for (int r = M + lane; r < P; r += 32) xv[r] = 0.f;
  __syncwarp();

  for (int f = 0; f < F; ++f) {
    const size_t row = rb + f;
    cp_async_wait<OBS_RING - 2>();   // the observations of frame f
    __syncwarp();
    if (f + OBS_RING - 1 < F)
      fetch_obs<EPL>(ring + (f + OBS_RING - 1) % OBS_RING * 32 * EPL,
                     g.obs + (row + OBS_RING - 1) * E, E, lane);
    cp_async_commit();
    const float* o = ring + f % OBS_RING * 32 * EPL + lane * EPL;
    // -- the records of the carry entering the frame, from registers
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 32 * h + lane;
      if (d < M) {
        g.entry_val[row * M + d] = en_r[h];
        put_id<IdT>(g.entry_edge, row * M + d, eg_r[h]);
        put_id<IdT>(g.ex_am, row * M + d, xid[h]);
      }
    }
    if constexpr (!RED) {
#pragma unroll 1
      for (int m = 64 + lane; m < M; m += 32) {
        g.entry_val[row * M + m] = en[m];
        put_id<IdT>(g.entry_edge, row * M + m, eg[m]);
        put_id<IdT>(g.ex_am, row * M + m, __ldg(g.id_exit + m));
      }
    }
    // -- in-model pass; the state below a lane's first is the last of the
    // lane below
    float pa = __shfl_up_sync(0xffffffffu, a[EPL - 1], 1);
    if (lane == 0) pa = NEG;
    float na[EPL];
    int nid[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float v = a[j] + ws[j];
      int id = id_self[j];
      const float adv = (j ? a[j - 1] : pa) + wa[j];
      if (adv >= v) {
        v = adv;
        id = id_adv[j];
      }
      const float ent = en[mo[j]] + we[j];
      if (ent >= v) {
        v = ent;
        id = id_ent[j];
      }
      na[j] = v + o[j];
      nid[j] = id;
    }
    // -- beam against the stream's best state
    float mx = na[0];
#pragma unroll
    for (int j = 1; j < EPL; ++j) mx = fmaxf(mx, na[j]);
    const float thresh = warp_max(mx) - bm;
#pragma unroll
    for (int j = 0; j < EPL; ++j) na[j] = na[j] >= thresh ? na[j] : NEG;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane * EPL + j;
      if (e < E) put_id<IdT>(g.in_am, row * E + e, nid[j]);
    }
    const bool live = f < nv;

    if constexpr (RED) {
      // -- closure and sinks, 1: each distinct column's first maximum over
      // the exits, a lane's own (ascending) then the warp's by redux; the
      // columns' results in scalars (an array here went to local memory)
      static_assert(RED_COLUMNS == 4, "the columns' scalars below");
      float v0, v1, v2, v3;
      int k0, k1, k2, k3;
      redux_column<EPL>(na, wx, tb[0], mo, last, 0 < U, v0, k0);
      redux_column<EPL>(na, wx, tb[1], mo, last, 1 < U, v1, k1);
      redux_column<EPL>(na, wx, tb[2], mo, last, 2 < U, v2, k2);
      redux_column<EPL>(na, wx, tb[3], mo, last, 3 < U, v3, k3);
      // 2: each destination (D <= 64) takes its column's best and its own
      // edge id
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 32 * h + lane, c = cu[h];
        const float v = c == 3 ? v3 : c == 2 ? v2 : c == 1 ? v1 : v0;
        const int k = c == 3 ? k3 : c == 2 ? k2 : c == 1 ? k1 : k0;
        if (d < D) {
          const int id = k >= 0 ? ids[d * P + k] : -1;
          if (d < M) {
            put_id<IdT>(g.cm_am, row * M + d, id);
            if (live) {
              en_r[h] = v >= thresh ? v : NEG;
              eg_r[h] = id;
              en[d] = en_r[h];
            }
          } else {
            g.sink_val[row * S + (d - M)] = v;
            put_id<IdT>(g.cs_am, row * S + (d - M), id);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if (last >> j & 1) xv[mo[j]] = na[j] + wx[j];
      __syncwarp();
      // -- closure and sinks, 1: the best source of each distinct column
      float bv = NEG;
      int bk = -1;
      if (one) {
        best_in_lanes(xv, tab, P, cs, lane, bv, bk);
      } else {
        best_sources(xv, tab, P, U, cs, lane, uv, uk);
        __syncwarp();
      }
      // 2: each destination takes its distinct column's best and its own
      // edge id; the first 64 keep their carry in registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 32 * h + lane;
        float v;
        int k;
        if (one) {
          v = __shfl_sync(0xffffffffu, bv, cu[h] << cs.lg);
          k = __shfl_sync(0xffffffffu, bk, cu[h] << cs.lg);
        } else {
          v = uv[cu[h]];
          k = uk[cu[h]];
        }
        if (d < D) {
          const int id = k >= 0 ? ids[(size_t)d * P + k] : -1;
          if (d < M) {
            put_id<IdT>(g.cm_am, row * M + d, id);
            if (live) {
              en_r[h] = v >= thresh ? v : NEG;
              eg_r[h] = id;
              en[d] = en_r[h];
            }
          } else {
            g.sink_val[row * S + (d - M)] = v;
            put_id<IdT>(g.cs_am, row * S + (d - M), id);
          }
        }
      }
#pragma unroll 1
      for (int d0 = 64; d0 < D; d0 += 32) {   // wide networks
        const int d = d0 + lane;
        const int u = d < D ? col_of[d] : 0;
        float v;
        int k;
        if (one) {
          v = __shfl_sync(0xffffffffu, bv, u << cs.lg);
          k = __shfl_sync(0xffffffffu, bk, u << cs.lg);
        } else {
          v = uv[u];
          k = uk[u];
        }
        if (d >= D) continue;
        const int id = k >= 0 ? ids[(size_t)d * P + k] : -1;
        if (d < M) {
          put_id<IdT>(g.cm_am, row * M + d, id);
          if (live) {
            en[d] = v >= thresh ? v : NEG;
            eg[d] = id;
          }
        } else {
          g.sink_val[row * S + (d - M)] = v;
          put_id<IdT>(g.cs_am, row * S + (d - M), id);
        }
      }
    }
    if (live) {  // a dead frame keeps the carry
#pragma unroll
      for (int j = 0; j < EPL; ++j) a[j] = na[j];
    }
    __syncwarp();   // the new entries, before the next in-model pass
  }

#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane * EPL + j;
    if (e < E) g.alpha_out[(size_t)b * E + e] = a[j];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = 32 * h + lane;
    if (d < M) {
      g.entry_out[(size_t)b * M + d] = en_r[h];
      g.edge_out[(size_t)b * M + d] = eg_r[h];
    }
  }
  if constexpr (!RED) {
#pragma unroll 1
    for (int m = 64 + lane; m < M; m += 32) {
      g.entry_out[(size_t)b * M + m] = en[m];
      g.edge_out[(size_t)b * M + m] = eg[m];
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
}

using Kernel = void (*)(const Args);

// int16 ids (every network whose ids fit, the serving case): every
// states-per-lane instance of EPLS
template <bool SMEM_TAB>
Kernel pick16(int epl) {
  switch (epl) {
    case 1: return net_decode_kernel<1, SMEM_TAB, int16_t, false>;
    case 2: return net_decode_kernel<2, SMEM_TAB, int16_t, false>;
    case 3: return net_decode_kernel<3, SMEM_TAB, int16_t, false>;
    case 4: return net_decode_kernel<4, SMEM_TAB, int16_t, false>;
    case 5: return net_decode_kernel<5, SMEM_TAB, int16_t, false>;
    case 6: return net_decode_kernel<6, SMEM_TAB, int16_t, false>;
    case 8: return net_decode_kernel<8, SMEM_TAB, int16_t, false>;
    case 12: return net_decode_kernel<12, SMEM_TAB, int16_t, false>;
    case 16: return net_decode_kernel<16, SMEM_TAB, int16_t, false>;
    case 24: return net_decode_kernel<24, SMEM_TAB, int16_t, false>;
    default: return net_decode_kernel<32, SMEM_TAB, int16_t, false>;
  }
}

// int32 ids (networks of 2^15 edges or more of a kind): powers of two
// only, the next one up (fewer instances to build; idle lane slots cost
// time, not results)
template <bool SMEM_TAB>
Kernel pick32(int epl) {
  if (epl <= 1) return net_decode_kernel<1, SMEM_TAB, int, false>;
  if (epl <= 2) return net_decode_kernel<2, SMEM_TAB, int, false>;
  if (epl <= 4) return net_decode_kernel<4, SMEM_TAB, int, false>;
  if (epl <= 8) return net_decode_kernel<8, SMEM_TAB, int, false>;
  if (epl <= 16) return net_decode_kernel<16, SMEM_TAB, int, false>;
  return net_decode_kernel<32, SMEM_TAB, int, false>;
}

// The redux instance (U <= RED_COLUMNS, M + S <= 64, tables staged): the
// states-per-lane instances up to RED_EPL, int16 at each, int32 at the
// powers of two.
Kernel pick_redux(int epl, bool id16) {
  if (!id16) {
    if (epl <= 1) return net_decode_kernel<1, true, int, true>;
    if (epl <= 2) return net_decode_kernel<2, true, int, true>;
    if (epl <= 4) return net_decode_kernel<4, true, int, true>;
    return net_decode_kernel<8, true, int, true>;
  }
  switch (epl) {
    case 1: return net_decode_kernel<1, true, int16_t, true>;
    case 2: return net_decode_kernel<2, true, int16_t, true>;
    case 3: return net_decode_kernel<3, true, int16_t, true>;
    case 4: return net_decode_kernel<4, true, int16_t, true>;
    case 5: return net_decode_kernel<5, true, int16_t, true>;
    case 6: return net_decode_kernel<6, true, int16_t, true>;
    default: return net_decode_kernel<8, true, int16_t, true>;
  }
}

}  // namespace

// Whether a launch takes the redux instance: few distinct columns, every
// destination in a lane's two registers, the states a lane within
// RED_EPL (epl_k: the instance's), the tables in shared memory.
static bool redux_instance(int U, int D, int epl_k, bool smem_tab) {
  return U <= RED_COLUMNS && D <= 64 && epl_k <= RED_EPL && smem_tab;
}

// One block of frames of the decode-mode dense network step for n streams:
// obs [n, F, E] f32; carry alpha [n, E], entry [n, M] f32, entry edge
// [n, M] i32; structured weights w_self/w_adv/w_entry [E], w_exit [M];
// ids id_in [E][4] (self, adv, entry; the fourth unused) and id_exit [M];
// the edge tables tab f32 [U rounded up to 32][P], col_of i32 [M + S],
// ids i32 [M + S][P]; n_valid i32 [n], beam f32 [n] -> carry out and the
// records [n, F, .] (ids int16 where id16, else int32).  Launches on
// `stream`, allocates nothing, does not synchronise.
extern "C" int phn_net_decode(
    const void* obs, const void* alpha0, const void* entry0,
    const void* edge0, const void* w_self, const void* w_adv,
    const void* w_entry, const void* w_exit, const void* id_in,
    const void* id_exit, const void* tab, const void* col_of,
    const void* ids, const void* n_valid, const void* beam, int F, int n,
    int E, int M, int S, int S_M, int P, int U, int id16, void* alpha_out,
    void* entry_out, void* edge_out, void* in_am, void* ex_am, void* cm_am,
    void* entry_edge, void* entry_val, void* sink_val, void* cs_am,
    void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F < 0 || E <= 0 || M <= 0 || S <= 0 || S_M <= 0 || E != M * S_M ||
      E > MAX_E || P < M || P % 4 || U < 1 || U > M + S)
    return cudaErrorInvalidValue;
  const int U_pad = (U + 31) / 32 * 32, D = M + S;
  const int epl = states_per_lane(E);
  int epl_k = epl;   // int32 ids: the power-of-two instance at or above
  while (!id16 && (epl_k & (epl_k - 1))) ++epl_k;
  const size_t slice =
      sizeof(float) * (P + (2 * (size_t)M + 2 * (size_t)U + 3) / 4 * 4 +
                       (size_t)OBS_RING * 32 * epl_k);
  const size_t tables =
      sizeof(float) * ((size_t)U_pad * P + ((size_t)D + 3) / 4 * 4 +
                       (size_t)D * P);
  int w;
  bool smem_tab;
  size_t smem;
  cudaError_t err = plan_blocks(tables, slice, &w, &smem_tab, &smem);
  if (err != cudaSuccess) return err;
  const Kernel k =
      redux_instance(U, D, epl_k, smem_tab)
          ? pick_redux(epl, id16)
          : id16 ? (smem_tab ? pick16<true>(epl) : pick16<false>(epl))
                 : (smem_tab ? pick32<true>(epl) : pick32<false>(epl));
  err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  Args g;
  g.obs = static_cast<const float*>(obs);
  g.alpha0 = static_cast<const float*>(alpha0);
  g.entry0 = static_cast<const float*>(entry0);
  g.edge0 = static_cast<const int*>(edge0);
  g.w_self = static_cast<const float*>(w_self);
  g.w_adv = static_cast<const float*>(w_adv);
  g.w_entry = static_cast<const float*>(w_entry);
  g.w_exit = static_cast<const float*>(w_exit);
  g.id_in = static_cast<const int*>(id_in);
  g.id_exit = static_cast<const int*>(id_exit);
  g.tab = static_cast<const float*>(tab);
  g.col_of = static_cast<const int*>(col_of);
  g.ids = static_cast<const int*>(ids);
  g.n_valid = static_cast<const int*>(n_valid);
  g.beam = static_cast<const float*>(beam);
  g.F = F;
  g.n = n;
  g.E = E;
  g.M = M;
  g.S = S;
  g.S_M = S_M;
  g.P = P;
  g.U = U;
  g.alpha_out = static_cast<float*>(alpha_out);
  g.entry_out = static_cast<float*>(entry_out);
  g.edge_out = static_cast<int*>(edge_out);
  g.in_am = in_am;
  g.ex_am = ex_am;
  g.cm_am = cm_am;
  g.entry_edge = entry_edge;
  g.cs_am = cs_am;
  g.entry_val = static_cast<float*>(entry_val);
  g.sink_val = static_cast<float*>(sink_val);
  k<<<(n + w - 1) / w, 32 * w, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}
