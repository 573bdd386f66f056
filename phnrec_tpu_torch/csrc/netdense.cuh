// Parts shared by the dense network-Viterbi kernels B (netstep.cu, the
// KWS block) and E (netdecode.cu, the decode-mode block), for sm_90a: the
// beam max, the first-maximum update, the first pass of the closure and
// the sinks over the distinct destination columns, the states-per-lane
// instances and the streams-per-block plan.  Both kernels run a warp per
// stream with its states in registers; netstep.cu's header describes the
// edge tables and the two-pass closure.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace netdense {

constexpr float NEG = -1e30f;
constexpr int MAX_E = 1024;  // the wrappers' MAX_E (ops/netstep.py)
constexpr int MAX_STREAMS_PER_BLOCK = 4;

// the instantiated states-per-lane counts, ascending
constexpr int EPLS[] = {1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32};

// The smallest instance that holds E states in a warp's 32 lanes.
inline int states_per_lane(int E) {
  for (int c : EPLS)
    if (c * 32 >= E) return c;
  return 32;
}

// The largest of a warp's floats, exactly: max over the integers that
// order the floats as their values do (no NaN here).
__device__ __forceinline__ float warp_max(float v) {
  int i = __float_as_int(v);
  i = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// strict-greater update: the first source of the best value wins.  The
// value runs through fmaxf, which equals the update (on c == v both are
// the same number; only -0.0 against +0.0 could differ, and no sum here
// is -0.0), so its chain is one instruction a source; the source index
// follows the compare beside it.
__device__ __forceinline__ void take(float& v, int& k, float c, int r) {
  const bool gt = c > v;
  v = fmaxf(v, c);
  k = gt ? r : k;
}

// G lanes split each distinct column's sources (G a power of two, as many
// as leave every lane a column and a group >= 4 sources), SG sources a
// lane, over the M sources rounded up to 4 (M4).
struct ColumnSplit {
  int lg, G, SG, M4;
};

__device__ __forceinline__ ColumnSplit column_split(int U, int M) {
  ColumnSplit c;
  c.M4 = (M + 3) / 4 * 4;
  c.lg = 0;
  while ((U << (c.lg + 1)) <= 32 && (4 << (c.lg + 1)) <= c.M4) ++c.lg;
  c.G = 1 << c.lg;
  c.SG = ((c.M4 + c.G - 1) / c.G + 3) / 4 * 4;
  return c;
}

// The closure's and the sinks' first pass: the best source of each of the
// U distinct columns (tab [U_pad][P]) over the exits xv [P], its sources
// split over G lanes, each walked ascending, then merged keeping the
// first maximum (the higher value, on equal values the lower source);
// uv[u] / uk[u] get the best value and its source (-1: none above NEG).
// x[r] is read as a broadcast and the weights as 16-byte loads, 4 sources
// a step.
__device__ __forceinline__ void best_sources(const float* xv,
                                             const float* tab, int P, int U,
                                             const ColumnSplit& c, int lane,
                                             float* uv, int* uk) {
  for (int u0 = 0; u0 < U; u0 += 32 >> c.lg) {
    const int u = u0 + (lane >> c.lg), g = lane & (c.G - 1);
    const float* t = tab + (size_t)u * P;
    float v = NEG;
    int k = -1;
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
    if (g == 0 && u < U) {
      uv[u] = v;
      uk[u] = k;
    }
  }
}

// The launch plan: the edge tables (`tables` bytes) go to shared memory,
// shared by the block's streams, where they fit beside one warp's slice
// (`slice` bytes), else they are read from device memory; then as many
// streams a block, up to MAX_STREAMS_PER_BLOCK, as shared memory holds.
// Sets the streams a block, whether the tables are staged, and the
// dynamic shared memory; cudaErrorInvalidValue when one slice does not
// fit.
inline cudaError_t plan_blocks(size_t tables, size_t slice, int* streams,
                               bool* smem_tab, size_t* smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int w = MAX_STREAMS_PER_BLOCK;
  *smem_tab = tables + slice <= (size_t)optin;
  if (*smem_tab) {
    while (w > 1 && tables + w * slice > (size_t)optin) --w;
  } else {
    while (w > 1 && w * slice > (size_t)optin) --w;
    if (slice > (size_t)optin) return cudaErrorInvalidValue;
  }
  *streams = w;
  *smem = (*smem_tab ? tables : 0) + w * slice;
  return cudaSuccess;
}

}  // namespace netdense
