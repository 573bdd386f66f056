// Dense network-Viterbi block over F frames for n streams, for sm_90a.
//
// Replaces: phnrec_tpu/ops/pallas_netstep.py::build_net_block_fn (the
// Pallas kernel `kernel`, pallas_netstep.py:110-207, called at :231).
// Semantics per stream and frame (ViterbiStep on a uniform-S left-to-right
// network; E states, M models of S_M states each, S sinks):
//
//   in-model pass, state e of model m = e / S_M:
//     self  = alpha[e]   + w_self[e]
//     adv   = alpha[e-1] + w_adv[e]        (NEG weight at a model's first)
//     entry = entry[m]   + w_entry[e]      (NEG weight past the first)
//     a'[e] = best of (self, adv, entry), ties entry > adv > self (>=),
//             its word time wt' from the same source; a'[e] += obs[e]
//   beam:   a' < max_e a' - beam  ->  NEG
//   exit:   x[m] = a'[(m+1)*S_M - 1] + w_exit[m]  (word time alongside)
//   closure: entry'[m] = max over live edges r -> m of x[r] + A_cm[r, m],
//             sources ascending, strict-greater updates; below the beam
//             threshold -> NEG; its word time is n_dec + 1 + f when the
//             winning edge crosses a word (R_cm), else the source's
//   sinks:  sink_val[s] = max over live edges r -> s of x[r] + A_cs[r, s]
//
// A frame f >= n_valid leaves the carry as it was (its sink records are
// still written, from the carry).  Adds and compares only: the records are
// bit-equal to DenseKWSScan.step on live entries.
//
// The edge tables.  The closure and the sinks read the destination
// columns (models, then sinks; D = M + S) of one dense table by source
// model r: A_cm[r, d] or A_cs[r, d - M] where the edge is live (> NEG / 2),
// -INFINITY where it is not.  Columns that are equal (a phone-loop
// filler's models all share one) are stored once: tab[u][r] holds the U
// distinct columns (rows padded to a multiple of 32, sources to the row
// stride P with -INFINITY) and col_of[d] maps a destination to its row.
// x[r] is finite (the padding sources read 0), so a dead edge's candidate
// is -INFINITY and never passes the strict-greater test against the
// running best, which starts at NEG: a walk over all sources in ascending
// order takes the same decisions as a walk over the live edges alone, and
// equal columns take equal decisions.  A walk split over G lanes keeps the
// first maximum when it merges: the higher value wins, on equal values the
// lower source.  The reset flags R_cm[r, d] sit beside it as bytes,
// reset[d][r], read once per destination and frame for the winning
// source.  The tables are staged once per launch into shared memory,
// shared by the block's streams, where they fit (the EN KWS net: 11
// distinct columns of 52, 9.4 KB), else read from global memory.
//
// What bounds it on the H100: the 512-odd frames of a block depend on each
// other, and a frame is a chain of dependent steps (in-model pass, beam
// max, exits, a closure of M ascending compare-selects per column,
// entries), so it is latency-bound, far below the memory rate; and with
// n = 256 streams there is about one warp for each of the card's 528
// schedulers, so nothing hides that latency but the instruction-level
// parallelism inside a warp.
//
// Design: one warp per stream, several streams per block sharing the
// staged tables, and no block barrier in the frame loop (one after the
// staging).  Lane l holds states l*EPL .. l*EPL + EPL-1 (alpha, word
// times, their weights and the next frame's observations) in registers;
// alpha[e-1] of a lane's first state comes from the lane below by shuffle,
// the beam max is one warp reduction (redux on the floats' ordered integer
// keys).  Exits pass through the warp's own slice of shared memory under
// __syncwarp.  The closure and the sinks run in two passes: G lanes walk
// each distinct column's sources (32 / G columns at a time), reading x[r]
// as a broadcast and the weights as 16-byte loads, 4 sources a step, and
// merge their bests by shuffle; then each destination (a sink has a lane
// of its own, beside the models'; two a lane, their loads issued together,
// the first 64 destinations' column rows kept in registers) takes its
// column's best, its word time and reset, and writes the entry or the
// sink record.  The next frame's
// observations are loaded before the beam and the closure, so their
// latency overlaps them.  The beam max, the closure's first pass and the
// launch plan are in netdense.cuh, shared with kernel E (netdecode.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "netdense.cuh"

namespace {

using namespace netdense;

template <int EPL, bool SMEM_TAB>
__global__ void __launch_bounds__(32 * MAX_STREAMS_PER_BLOCK)
net_block_kernel(
    const float* __restrict__ obs, const float* __restrict__ alpha0,
    const int* __restrict__ wt0, const float* __restrict__ entry0,
    const int* __restrict__ ewt0, const float* __restrict__ w_self,
    const float* __restrict__ w_adv, const float* __restrict__ w_entry,
    const float* __restrict__ w_exit, const float* __restrict__ tab_g,
    const int* __restrict__ col_g, const int8_t* __restrict__ reset_g,
    const int* __restrict__ n_valid, const int* __restrict__ n_dec,
    const float* __restrict__ beam, int F, int n, int E, int M, int S,
    int S_M, int P, int U, float* __restrict__ alpha_out,
    int* __restrict__ wt_out,
    float* __restrict__ entry_out, int* __restrict__ ewt_out,
    float* __restrict__ sink_val, int* __restrict__ sink_wt) {
  extern __shared__ __align__(16) float smem[];
  const int D = M + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int U_pad = (U + 31) / 32 * 32;
  // [U_pad][P] table, [D] column map and [M][P] reset bytes (if staged),
  // then per warp: [P] exit value, [M] exit word time, [M] entry, [M]
  // entry word time, [U] best value and [U] best source of each column
  const size_t tab_floats =
      SMEM_TAB ? (size_t)U_pad * P + (D + 3) / 4 * 4 +
                     ((size_t)M * P + 15) / 16 * 4
               : 0;
  const int slice = P + (3 * M + 2 * U + 3) / 4 * 4;
  float* tab_s = smem;
  int* col_s = reinterpret_cast<int*>(smem + (size_t)U_pad * P);
  int8_t* reset_s = reinterpret_cast<int8_t*>(col_s + (D + 3) / 4 * 4);
  float* xv = smem + tab_floats + (size_t)warp * slice;
  int* xw = reinterpret_cast<int*>(xv + P);
  float* en = reinterpret_cast<float*>(xw + M);
  int* ew = reinterpret_cast<int*>(en + M);
  float* uv = reinterpret_cast<float*>(ew + M);
  int* uk = reinterpret_cast<int*>(uv + U);

  if (SMEM_TAB) {
    const float4* src = reinterpret_cast<const float4*>(tab_g);
    float4* dst = reinterpret_cast<float4*>(tab_s);
    for (int i = threadIdx.x; i < U_pad * P / 4; i += blockDim.x)
      dst[i] = src[i];
    for (int i = threadIdx.x; i < D; i += blockDim.x) col_s[i] = col_g[i];
    const int* rsrc = reinterpret_cast<const int*>(reset_g);
    int* rdst = reinterpret_cast<int*>(reset_s);
    for (int i = threadIdx.x; i < M * P / 4; i += blockDim.x)
      rdst[i] = rsrc[i];
  }
  __syncthreads();  // the tables are read by every warp of the block
  const float* tab = SMEM_TAB ? tab_s : tab_g;
  const int* col_of = SMEM_TAB ? col_s : col_g;
  const int8_t* reset = SMEM_TAB ? reset_s : reset_g;
  const ColumnSplit cs = column_split(U, M);

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= n) return;
  const int nv = n_valid[b];
  const int t_base = n_dec[b] + 1;
  const float bm = beam[b];

  // lane-held states: alpha, word time, weights, model, observation.  The
  // padding states (e >= E) have -INFINITY weights, so they never raise
  // the beam max, and nothing reads them.
  float a[EPL], ws[EPL], wa[EPL], we[EPL], wx[EPL], o[EPL];
  int wt[EPL], mo[EPL];
  unsigned last = 0;  // bit j: slot j is its model's last state
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane * EPL + j;
    const bool in = e < E;
    a[j] = in ? alpha0[(size_t)b * E + e] : NEG;
    wt[j] = in ? wt0[(size_t)b * E + e] : 0;
    ws[j] = in ? w_self[e] : -INFINITY;
    wa[j] = in ? w_adv[e] : -INFINITY;
    we[j] = in ? w_entry[e] : -INFINITY;
    mo[j] = in ? e / S_M : 0;
    wx[j] = in ? w_exit[mo[j]] : 0.f;
    if (in && e % S_M == S_M - 1) last |= 1u << j;
    o[j] = (in && F > 0) ? obs[(size_t)b * E + e] : 0.f;
  }
  for (int m = lane; m < M; m += 32) {
    en[m] = entry0[(size_t)b * M + m];
    ew[m] = ewt0[(size_t)b * M + m];
  }
  for (int r = M + lane; r < P; r += 32) xv[r] = 0.f;
  // the first 64 destinations' columns, frame-invariant
  const int cu[2] = {lane < D ? col_of[lane] : 0,
                     lane + 32 < D ? col_of[lane + 32] : 0};
  __syncwarp();

  for (int f = 0; f < F; ++f) {
    // -- in-model pass; the state below a lane's first is the last of the
    // lane below
    float pa = __shfl_up_sync(0xffffffffu, a[EPL - 1], 1);
    int pw = __shfl_up_sync(0xffffffffu, wt[EPL - 1], 1);
    if (lane == 0) {
      pa = NEG;
      pw = 0;
    }
    float na[EPL];
    int nw[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      float v = a[j] + ws[j];
      int w = wt[j];
      const float adv = (j ? a[j - 1] : pa) + wa[j];
      if (adv >= v) {
        v = adv;
        w = j ? wt[j - 1] : pw;
      }
      const float ent = en[mo[j]] + we[j];
      if (ent >= v) {
        v = ent;
        w = ew[mo[j]];
      }
      na[j] = v + o[j];
      nw[j] = w;
    }
    if (f + 1 < F) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = lane * EPL + j;
        if (e < E) o[j] = obs[((size_t)(f + 1) * n + b) * E + e];
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
      // -- exit pass: the last state of each model
      if (last >> j & 1) {
        xv[mo[j]] = na[j] + wx[j];
        xw[mo[j]] = nw[j];
      }
    }
    __syncwarp();

    // -- closure (exits -> entries) and sinks, 1: the best source of
    // each distinct column
    const bool live = f < nv;
    best_sources(xv, tab, P, U, cs, lane, uv, uk);
    __syncwarp();
    // 2: each destination column takes its distinct column's best, two
    // destinations a lane side by side
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
        const int w = k >= 0 ? xw[k] : 0;
        const bool rs = k >= 0 && d < M && reset[(size_t)d * P + k];
        if (d < M) {
          if (live) {
            en[d] = vv[h] >= thresh ? vv[h] : NEG;
            ew[d] = rs ? t_base + f : w;
          }
        } else if (d < D) {
          const size_t idx = ((size_t)f * n + b) * S + (d - M);
          sink_val[idx] = vv[h];
          sink_wt[idx] = w;
        }
      }
    }
    if (live) {  // a dead frame keeps the carry
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        a[j] = na[j];
        wt[j] = nw[j];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int e = lane * EPL + j;
    if (e < E) {
      alpha_out[(size_t)b * E + e] = a[j];
      wt_out[(size_t)b * E + e] = wt[j];
    }
  }
  for (int m = lane; m < M; m += 32) {
    entry_out[(size_t)b * M + m] = en[m];
    ewt_out[(size_t)b * M + m] = ew[m];
  }
}

using Kernel = void (*)(const float*, const float*, const int*, const float*,
                        const int*, const float*, const float*, const float*,
                        const float*, const float*, const int*,
                        const int8_t*, const int*, const int*, const float*,
                        int, int, int, int, int, int, int, int, float*, int*,
                        float*, int*, float*, int*);

template <bool SMEM_TAB>
Kernel pick(int epl) {
  switch (epl) {
    case 1: return net_block_kernel<1, SMEM_TAB>;
    case 2: return net_block_kernel<2, SMEM_TAB>;
    case 3: return net_block_kernel<3, SMEM_TAB>;
    case 4: return net_block_kernel<4, SMEM_TAB>;
    case 5: return net_block_kernel<5, SMEM_TAB>;
    case 6: return net_block_kernel<6, SMEM_TAB>;
    case 8: return net_block_kernel<8, SMEM_TAB>;
    case 12: return net_block_kernel<12, SMEM_TAB>;
    case 16: return net_block_kernel<16, SMEM_TAB>;
    case 24: return net_block_kernel<24, SMEM_TAB>;
    default: return net_block_kernel<32, SMEM_TAB>;
  }
}

}  // namespace

// One block of frames of the dense network step for n streams: obs
// [F, n, E] f32; carry alpha/wt [n, E], entry/entry_wt [n, M]; structured
// weights w_self/w_adv/w_entry [E], w_exit [M]; the edge tables (see the
// header) tab f32 [U rounded up to 32][P] of U distinct columns, col_of
// i32 [M + S] and reset i8 [M][P]; n_valid/n_dec i32 [n], beam f32 [n]
// -> carry out and sink records [F, n, S].  MAX_STREAMS_PER_BLOCK streams
// a block, fewer where shared memory runs short; n need not be a
// multiple.  Launches on `stream`, allocates nothing, does not
// synchronise.
extern "C" int phn_net_block(
    const void* obs, const void* alpha0, const void* wt0, const void* entry0,
    const void* ewt0, const void* w_self, const void* w_adv,
    const void* w_entry, const void* w_exit, const void* tab,
    const void* col_of, const void* reset, const void* n_valid,
    const void* n_dec, const void* beam, int F, int n, int E, int M, int S,
    int S_M, int P, int U, void* alpha_out, void* wt_out, void* entry_out,
    void* ewt_out, void* sink_val, void* sink_wt, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (F < 0 || E <= 0 || M <= 0 || S <= 0 || S_M <= 0 || E != M * S_M ||
      E > MAX_E || P < M || P % 4 || U < 1 || U > M + S)
    return cudaErrorInvalidValue;
  const int U_pad = (U + 31) / 32 * 32, D = M + S;
  const int epl = states_per_lane(E);
  const size_t slice =
      sizeof(float) * (P + (3 * (size_t)M + 2 * (size_t)U + 3) / 4 * 4);
  const size_t tables = sizeof(float) * ((size_t)U_pad * P +
                                         ((size_t)D + 3) / 4 * 4) +
                        ((size_t)M * P + 15) / 16 * 16;
  int w;
  bool smem_tab;
  size_t smem;
  cudaError_t err = plan_blocks(tables, slice, &w, &smem_tab, &smem);
  if (err != cudaSuccess) return err;
  const Kernel k = smem_tab ? pick<true>(epl) : pick<false>(epl);
  err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k<<<(n + w - 1) / w, 32 * w, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<const float*>(alpha0),
      static_cast<const int*>(wt0), static_cast<const float*>(entry0),
      static_cast<const int*>(ewt0), static_cast<const float*>(w_self),
      static_cast<const float*>(w_adv), static_cast<const float*>(w_entry),
      static_cast<const float*>(w_exit), static_cast<const float*>(tab),
      static_cast<const int*>(col_of), static_cast<const int8_t*>(reset),
      static_cast<const int*>(n_valid), static_cast<const int*>(n_dec),
      static_cast<const float*>(beam), F, n, E, M, S, S_M, P, U,
      static_cast<float*>(alpha_out),
      static_cast<int*>(wt_out), static_cast<float*>(entry_out),
      static_cast<int*>(ewt_out), static_cast<float*>(sink_val),
      static_cast<int*>(sink_wt));
  return cudaGetLastError();
}

extern "C" int phn_net_block_max_e() { return MAX_E; }
