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
// What bounds it on the H100: as kernel B, the chain of dependent steps in
// a frame and the 512-odd dependent frames of a block (latency, far below
// the memory rate: ~1.3 kB of records a frame and stream at the CZ loop);
// the records add stores that nothing waits on.
//
// Design: kernel B's (one warp a stream, its states in registers, the
// beam max by redux, the closure and the sinks over the distinct
// destination columns with the first maximum kept, the tables staged in
// shared memory where they fit; the parts both use are in netdense.cuh),
// with these changes: each lane holds its
// states' three candidate edge ids in registers beside their weights, and
// the in-model pass selects the winner's id as it selects its value; the
// exit ids of the first 64 models sit in registers; the closure's second
// pass looks the winning source's id up in an [M + S][P] id table beside
// the weights (shared memory with them, or device memory); the warp's
// slice of shared memory holds the carried entry edges where B's held the
// entry word times; the id type is a template parameter; the records of
// the carry entering frame f+1 are stored by the lanes that make it, from
// registers, in frame f's closure pass.
//
// Measured (PERF.md, CZ stkint loop, n 256 x F 512, NVIDIA H100 80GB
// HBM3, 700 W, devtools/netdecode_variants.py in turns): the first
// version, which loaded each state's winning id from device memory, chose
// the id width by a run-time flag at every store and stored each frame's
// carry records from shared memory at the frame's start, took 0.780 ms
// held, 3,014 clocks a frame; the ids in registers and the width a
// template parameter 0.549 (2,122); the carry records from the closure
// pass 0.435 (1,682), kernel B's clocks.  32-bit record offsets in place
// of 64-bit ones were slower (0.484, 1,872).

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

template <int EPL, bool SMEM_TAB, typename IdT>
__global__ void __launch_bounds__(32 * MAX_STREAMS_PER_BLOCK)
net_decode_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  const int M = g.M, E = g.E, S = g.S, P = g.P, U = g.U, F = g.F, n = g.n;
  const int D = M + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int U_pad = (U + 31) / 32 * 32;
  // [U_pad][P] table, [D] column map and [D][P] ids (if staged), then per
  // warp: [P] exit value, [M] entry, [M] entry edge, [U] best value and
  // [U] best source of each column
  const size_t tab_floats =
      SMEM_TAB ? (size_t)U_pad * P + (D + 3) / 4 * 4 + (size_t)D * P : 0;
  const int slice = P + (2 * M + 2 * U + 3) / 4 * 4;
  float* tab_s = smem;
  int* col_s = reinterpret_cast<int*>(smem + (size_t)U_pad * P);
  int* ids_s = col_s + (D + 3) / 4 * 4;
  float* xv = smem + tab_floats + (size_t)warp * slice;
  float* en = xv + P;
  int* eg = reinterpret_cast<int*>(en + M);
  float* uv = reinterpret_cast<float*>(eg + M);
  int* uk = reinterpret_cast<int*>(uv + U);

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

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;
  const int nv = g.n_valid[b];
  const float bm = g.beam[b];
  const size_t rb = (size_t)b * F;   // the stream's first record row

  float a[EPL], ws[EPL], wa[EPL], we[EPL], wx[EPL], o[EPL];
  int mo[EPL], id_self[EPL], id_adv[EPL], id_ent[EPL];
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
    o[j] = (in && F > 0) ? g.obs[rb * E + e] : 0.f;
    id_self[j] = in ? g.id_in[4 * e] : -1;
    id_adv[j] = in ? g.id_in[4 * e + 1] : -1;
    id_ent[j] = in ? g.id_in[4 * e + 2] : -1;
  }
  const int xid[2] = {lane < M ? g.id_exit[lane] : -1,
                      lane + 32 < M ? g.id_exit[lane + 32] : -1};
  for (int m = lane; m < M; m += 32) {
    en[m] = g.entry0[(size_t)b * M + m];
    eg[m] = g.edge0[(size_t)b * M + m];
  }
  for (int r = M + lane; r < P; r += 32) xv[r] = 0.f;
  const int cu[2] = {lane < D ? col_of[lane] : 0,
                     lane + 32 < D ? col_of[lane + 32] : 0};
  __syncwarp();

  // frame 0's records of the carry entering it, and the exit edges (the
  // later frames' are written as their carry is made)
  if (F > 0)
    for (int m = lane; m < M; m += 32) {
      g.entry_val[rb * M + m] = en[m];
      put_id<IdT>(g.entry_edge, rb * M + m, eg[m]);
      put_id<IdT>(g.ex_am, rb * M + m,
                  m < 64 ? xid[m >> 5] : __ldg(g.id_exit + m));
    }

  for (int f = 0; f < F; ++f) {
    const size_t row = rb + f;
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
    if (f + 1 < F) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = lane * EPL + j;
        if (e < E) o[j] = g.obs[(row + 1) * E + e];
      }
    }
    // -- beam against the stream's best state
    float mx = na[0];
#pragma unroll
    for (int j = 1; j < EPL; ++j) mx = fmaxf(mx, na[j]);
    const float thresh = warp_max(mx) - bm;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      na[j] = na[j] >= thresh ? na[j] : NEG;
      if (last >> j & 1) xv[mo[j]] = na[j] + wx[j];
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane * EPL + j;
      if (e < E) put_id<IdT>(g.in_am, row * E + e, nid[j]);
    }
    __syncwarp();

    // -- closure and sinks, 1: the best source of each distinct column
    const bool live = f < nv;
    best_sources(xv, tab, P, U, cs, lane, uv, uk);
    __syncwarp();
    // 2: each destination takes its distinct column's best and its own
    // edge id, two destinations a lane
    for (int d0 = 0; d0 < D; d0 += 64) {
      int dd[2], uu[2], kk[2];
      float vv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dd[h] = d0 + 32 * h + lane;
        uu[h] = d0 ? (dd[h] < D ? col_of[dd[h]] : 0) : cu[h];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        vv[h] = uv[uu[h]];
        kk[h] = uk[uu[h]];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = dd[h], k = kk[h];
        if (d >= D) continue;
        const int id = k >= 0 ? ids[(size_t)d * P + k] : -1;
        if (d < M) {
          put_id<IdT>(g.cm_am, row * M + d, id);
          float ne;
          int ng;
          if (live) {
            ne = vv[h] >= thresh ? vv[h] : NEG;
            ng = id;
            en[d] = ne;
            eg[d] = ng;
          } else {
            ne = en[d];
            ng = eg[d];
          }
          if (f + 1 < F) {  // the next frame's records of its carry
            const size_t nx = (row + 1) * M + d;
            g.entry_val[nx] = ne;
            put_id<IdT>(g.entry_edge, nx, ng);
            put_id<IdT>(g.ex_am, nx,
                        d < 64 ? xid[h] : __ldg(g.id_exit + d));
          }
        } else {
          g.sink_val[row * S + (d - M)] = vv[h];
          put_id<IdT>(g.cs_am, row * S + (d - M), id);
        }
      }
    }
    if (live) {  // a dead frame keeps the carry
#pragma unroll
      for (int j = 0; j < EPL; ++j) a[j] = na[j];
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane * EPL + j;
    if (e < E) g.alpha_out[(size_t)b * E + e] = a[j];
  }
  for (int m = lane; m < M; m += 32) {
    g.entry_out[(size_t)b * M + m] = en[m];
    g.edge_out[(size_t)b * M + m] = eg[m];
  }
}

using Kernel = void (*)(const Args);

// int16 ids (every network whose ids fit, the serving case): every
// states-per-lane instance of EPLS
template <bool SMEM_TAB>
Kernel pick16(int epl) {
  switch (epl) {
    case 1: return net_decode_kernel<1, SMEM_TAB, int16_t>;
    case 2: return net_decode_kernel<2, SMEM_TAB, int16_t>;
    case 3: return net_decode_kernel<3, SMEM_TAB, int16_t>;
    case 4: return net_decode_kernel<4, SMEM_TAB, int16_t>;
    case 5: return net_decode_kernel<5, SMEM_TAB, int16_t>;
    case 6: return net_decode_kernel<6, SMEM_TAB, int16_t>;
    case 8: return net_decode_kernel<8, SMEM_TAB, int16_t>;
    case 12: return net_decode_kernel<12, SMEM_TAB, int16_t>;
    case 16: return net_decode_kernel<16, SMEM_TAB, int16_t>;
    case 24: return net_decode_kernel<24, SMEM_TAB, int16_t>;
    default: return net_decode_kernel<32, SMEM_TAB, int16_t>;
  }
}

// int32 ids (networks of 2^15 edges or more of a kind): powers of two
// only, the next one up (fewer instances to build; idle lane slots cost
// time, not results)
template <bool SMEM_TAB>
Kernel pick32(int epl) {
  if (epl <= 1) return net_decode_kernel<1, SMEM_TAB, int>;
  if (epl <= 2) return net_decode_kernel<2, SMEM_TAB, int>;
  if (epl <= 4) return net_decode_kernel<4, SMEM_TAB, int>;
  if (epl <= 8) return net_decode_kernel<8, SMEM_TAB, int>;
  if (epl <= 16) return net_decode_kernel<16, SMEM_TAB, int>;
  return net_decode_kernel<32, SMEM_TAB, int>;
}

}  // namespace

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
  const size_t slice =
      sizeof(float) * (P + (2 * (size_t)M + 2 * (size_t)U + 3) / 4 * 4);
  const size_t tables =
      sizeof(float) * ((size_t)U_pad * P + ((size_t)D + 3) / 4 * 4 +
                       (size_t)D * P);
  int w;
  bool smem_tab;
  size_t smem;
  cudaError_t err = plan_blocks(tables, slice, &w, &smem_tab, &smem);
  if (err != cudaSuccess) return err;
  const Kernel k =
      id16 ? (smem_tab ? pick16<true>(epl) : pick16<false>(epl))
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
