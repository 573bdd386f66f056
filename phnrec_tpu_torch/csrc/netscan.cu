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
// frames, repeated T times, is the time.
//
// Design: a block per row, 256 threads, three barriers a frame.  Measured
// on the CZ loop (PERF.md): a thread per destination finding each slot's
// source through two dependent table loads took ~25,200 clocks a frame;
// this design takes ~6,500.
// * Each dense row is a list of 16-byte slots, made once on the host
//   (ops/netscan.slot_arrays): the source as an index into the phase's
//   value array ([entry | alpha | NEG] for the in-model pass, [alpha' |
//   NEG] for the exits, [exit values | NEG] for the closure and sinks; a
//   pad or a START edge reads the NEG sentinel with weight 0, so its value
//   is NEG exactly, as JAX's), the edge id, the word-time source of the
//   edge (of edge 0 for a pad, as JAX's clip; -1 where the closure edge
//   resets the word time) and the weight: one shared load a slot.
// * A group of L lanes takes a destination (L from the row's width: 1 for
//   2 slots, 4 for 47, so the CZ loop's 47 entries and its sink take one
//   round of the block's 64 groups), each lane a strided share of its
//   slots, then a shuffle reduction keeping the larger value and, on equal
//   values, the smaller slot: the first maximum, as JAX's argmax.
// * The slots, the carry and the frame's values live in shared memory,
//   and the next frame's observations are copied in by cp.async while a
//   frame runs, where they fit (up to 227 KB); otherwise the values sit
//   in a per-row scratch in device memory and the slots and observations
//   are read from device memory (both held to the plain version).  The
//   kernel is a template on the two, so the compiler knows each access's
//   memory space.
// * Records are stored as they are made, contiguous in the destination.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

struct Net {
  int E, M, S, n_cs;
  Tab in, ex, cm, cs;
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
// nwt [E], xv [M + 1], xwt [M], eedge [M]
__host__ __device__ inline int value_words(int E, int M) {
  return 4 * E + 5 * M + 3;
}

// the values, two frames of observations, then the slots (16-byte
// aligned)
__host__ __device__ inline size_t smem_bytes(int E, int M, int n_slots) {
  return 4 * ((size_t)value_words(E, M) + 2 * (size_t)E) + 16 + 16 * (size_t)n_slots;
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

__device__ __forceinline__ unsigned group_mask(int L, int lane) {
  return L == 32 ? 0xffffffffu : (((1u << L) - 1u) << (lane & ~(L - 1)));
}

// copy a table's slots to shared memory at p
__device__ __forceinline__ void stage(int4* p, const Tab& t) {
  const size_t n = (size_t)t.D * t.K;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) p[i] = t.slot[i];
}

// SMEM: the values, observations and slots in shared memory (a template
// parameter, so the compiler sees the address space of every access and
// may reorder them around the record stores); else in device memory.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
netscan_kernel(Net net, int T, const float* __restrict__ obs,
               const int* __restrict__ t0, const int* __restrict__ n_valid,
               const float* __restrict__ beam, Carry in, Carry out,
               Records rec, float* scratch) {
  extern __shared__ float smem[];
  __shared__ float warp_max[THREADS / 32];
  const int E = net.E, M = net.M, S = net.S;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float* base = SMEM ? smem : scratch + (size_t)b * value_words(E, M);
  float* vin = base;                                  // [entry | alpha | NEG]
  int* win = reinterpret_cast<int*>(vin + M + E + 1); // [entry_wt | wt]
  float* na = reinterpret_cast<float*>(win + M + E);  // [new alpha | NEG]
  int* nwt = reinterpret_cast<int*>(na + E + 1);
  float* xv = reinterpret_cast<float*>(nwt + E);      // [exit values | NEG]
  int* xwt = reinterpret_cast<int*>(xv + M + 1);
  int* eedge = xwt + M;
  float* obs_s = reinterpret_cast<float*>(eedge + M); // [2][E], smem only

  // the slot tables: staged into shared memory, or read where they are.
  // The pointers are chosen by the template parameter, so on the shared
  // path the compiler sees shared-memory pointers (a pointer reassigned
  // in the tables' struct stays generic: 32-bit generic loads of single
  // fields).
  const Tab &tin = net.in, &tex = net.ex, &tcm = net.cm, &tcs = net.cs;
  int4* staged = reinterpret_cast<int4*>(
      (reinterpret_cast<uintptr_t>(obs_s + 2 * E) + 15) & ~(uintptr_t)15);
  const size_t n_in = (size_t)tin.D * tin.K, n_ex = (size_t)tex.D * tex.K,
               n_cm = (size_t)tcm.D * tcm.K;
  const int4* s_in = SMEM ? staged : tin.slot;
  const int4* s_ex = SMEM ? staged + n_in : tex.slot;
  const int4* s_cm = SMEM ? staged + n_in + n_ex : tcm.slot;
  const int4* s_cs = SMEM ? staged + n_in + n_ex + n_cm : tcs.slot;
  if (SMEM) {
    stage(staged, tin);
    stage(staged + n_in, tex);
    stage(staged + n_in + n_ex, tcm);
    stage(staged + n_in + n_ex + n_cm, tcs);
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

    // phase 3: closure into the model entries, then the sinks (one list
    // of destinations, so the sinks take the groups the entries leave)
    {
      const int L = tcm.L > tcs.L ? tcm.L : tcs.L;
      const int gl = lane & (L - 1), groups = THREADS / L;
      const unsigned mask = group_mask(L, lane);
      const int n_dst = M + S;
      for (int d0 = 0; d0 < n_dst; d0 += groups) {
        const int d = d0 + tid / L;
        if (d0 + (warp * 32) / L >= n_dst) break;
        const bool sink = d >= M;
        const int dd = sink ? (d - M < S ? d - M : S - 1) : d;
        const int K = sink ? tcs.K : tcm.K;
        if (sink && net.n_cs == 0) {
          if (d < n_dst && gl == 0) {
            rec.sink_val[fr * S + dd] = NEG;
            rec.cs_am[fr * S + dd] = 0;
            rec.sink_wt[fr * S + dd] = 0;
          }
          continue;
        }
        float best;
        int bj;
        const int4* sl = (sink ? s_cs : s_cm) + (size_t)dd * K;
        group_max(sl, K, L, gl, mask, [&](int s) { return xv[s]; }, best, bj);
        if (d >= n_dst || gl != 0) continue;
        const int4 sj = sl[bj];
        if (!sink) {
          rec.cm_am[fr * M + d] = sj.y;
          if (valid) {
            vin[d] = pruned(best, thresh);
            eedge[d] = sj.y > 0 ? sj.y : 0;
            win[d] = sj.z < 0 ? t : xwt[sj.z];
          }
        } else {
          rec.sink_val[fr * S + dd] = best;
          rec.cs_am[fr * S + dd] = sj.y;
          rec.sink_wt[fr * S + dd] = xwt[sj.z];
        }
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

// lanes a destination of a row of K slots: up to 12 slots a lane, <= 32
int lanes_for(int K) {
  int L = 1;
  while (L < 32 && (K + L - 1) / L > 12) L <<= 1;
  return L;
}

}  // namespace

// shared memory a block needs to hold everything (0: more than it can)
extern "C" long long netscan_smem_bytes(int E, int M, int n_slots) {
  const size_t n = smem_bytes(E, M, n_slots);
  return n <= (size_t)SMEM_MAX ? (long long)n : 0;
}

// 4-byte words of a row's scratch in device memory when it does not fit
extern "C" int netscan_scratch_words(int E, int M) { return value_words(E, M); }

extern "C" int netscan(int B, int T, int E, int M, int S, int n_cs,
                       int Kin, int Kex, int Kcm, int Kcs,
                       const void* in_slot, const void* ex_slot,
                       const void* cm_slot, const void* cs_slot,
                       const void* obs, const void* t0, const void* n_valid,
                       const void* beam, void* alpha, void* wt, void* entry,
                       void* entry_edge, void* entry_wt, void* alpha_out,
                       void* wt_out, void* entry_out, void* entry_edge_out,
                       void* entry_wt_out, void* in_am, void* ex_am,
                       void* cm_am, void* r_entry_edge, void* entry_val,
                       void* sink_val, void* cs_am, void* sink_wt,
                       void* exit_val, void* scratch, int use_smem,
                       void* stream) {
  if (B <= 0) return cudaSuccess;
  if (T < 0 || E <= 0 || M <= 0 || S < 0 || n_cs < 0 || Kin <= 0 ||
      Kex <= 0 || Kcm <= 0 || Kcs <= 0)
    return cudaErrorInvalidValue;
  auto tab = [](const void* s, int D, int K) {
    return Tab{static_cast<const int4*>(s), D, K, lanes_for(K)};
  };
  Net net{E, M, S, n_cs, tab(in_slot, E, Kin), tab(ex_slot, M, Kex),
          tab(cm_slot, M, Kcm), tab(cs_slot, S, Kcs)};
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
  const size_t smem =
      smem_bytes(E, M, E * Kin + M * Kex + M * Kcm + S * Kcs);
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
