// Native host-runtime kernels of phnrec_tpu_torch.
//
// The reference implements its whole runtime in C++; the port keeps the
// compute path in PyTorch and hand-written CUDA kernels and implements
// the host-side runtime (waveform ingestion, HTK byte-order conversion,
// label backtracking, hypothesis alignment) natively here, exposed to
// Python via ctypes.  Copy of phnrec_tpu/native/src/phnrec_native.cpp
// (the same ABI, version 1).
//
// Reference semantics implemented (file:line cites are the reference
// C++ sources):
//   * A-law -> 13-bit linear decode table        alaw.cpp:14-48
//   * waveform convert: cast/decode, x8 A-law scale, DC shift, gain,
//     uniform dither                              srec.cpp:709-791, dspc.h:100-105
//   * portable LCG                                myrand.cpp:17-28
//   * 4/2-byte big-endian swaps for HTK files     matrix.h:2576-2590
//   * phoneme-loop Viterbi history backtrack      phndec.cpp:236-302
//   * HResults-style alignment (sub 10/ins 7/del 7)  STKLib/labels.C:525-527
//
// Everything is plain C ABI, 64-bit sizes, thread-safe (no globals except
// the const A-law table), so Python threads can run it with the GIL
// released via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__GNUC__)
#define PN_EXPORT extern "C" __attribute__((visibility("default")))
#else
#define PN_EXPORT extern "C"
#endif

// ---------------------------------------------------------------------------
// A-law table (derived from G.711, not copied: byte b -> XOR 0x55, split
// sign/exponent/mantissa, expand to the 13-bit magnitude; matches the
// reference's table alaw.cpp:14-48 exactly).
// ---------------------------------------------------------------------------
static const struct AlawTable {
    float v[256];
    AlawTable() {
        for (int b = 0; b < 256; ++b) {
            int a = b ^ 0x55;
            int sign = (a & 0x80) ? 1 : -1;
            int exponent = (a >> 4) & 0x07;
            int mantissa = a & 0x0F;
            int mag = (exponent == 0) ? ((mantissa << 1) | 1)
                                      : (((mantissa << 1) | 0x21)
                                         << (exponent - 1));
            v[b] = static_cast<float>(sign * mag);
        }
    }
} kAlaw;

// Portable LCG identical to the reference's myrand (myrand.cpp:17-28):
// next = next*1103515245 + 12345; out = (next >> 16) & 0x7fffffff.
static inline uint32_t pn_lcg(uint32_t* state) {
    *state = *state * 1103515245u + 12345u;
    return (*state >> 16) & 0x7fffffffu;
}

PN_EXPORT int32_t pn_myrand(uint32_t* state) {
    return static_cast<int32_t>(pn_lcg(state));
}

// ---------------------------------------------------------------------------
// Waveform conversion (srec.cpp:709-791).  out must hold
// max(n_samples, 200) floats; the first 200 are zero-filled before decode
// (MB_VECTORSIZE short-signal pad, srec.cpp:731-740, config.h:20).
// fmt: 0 = lin16 (little-endian int16), 1 = A-law bytes.
// noise_level != 0 adds uniform dither in [-level, level] (dspc.h:100-105)
// from the portable LCG seeded with `seed` (the reference uses libc rand();
// the LCG keeps results machine-independent).  Returns n_samples.
// ---------------------------------------------------------------------------
PN_EXPORT int64_t pn_convert_waveform(const uint8_t* raw, int64_t raw_len,
                                      int32_t fmt, float scale,
                                      float dc_shift, float noise_level,
                                      uint32_t seed, float* out,
                                      int64_t out_len) {
    const int64_t kMinPad = 200;
    int64_t n = (fmt == 0) ? raw_len / 2 : raw_len;
    int64_t total = n > kMinPad ? n : kMinPad;
    if (total > out_len) return -1;
    for (int64_t i = 0; i < kMinPad && i < total; ++i) out[i] = 0.0f;
    if (fmt == 0) {
        for (int64_t i = 0; i < n; ++i) {
            int16_t s = static_cast<int16_t>(
                static_cast<uint16_t>(raw[2 * i]) |
                (static_cast<uint16_t>(raw[2 * i + 1]) << 8));
            out[i] = static_cast<float>(s);
        }
    } else {
        for (int64_t i = 0; i < n; ++i) out[i] = 8.0f * kAlaw.v[raw[i]];
    }
    if (dc_shift != 0.0f)
        for (int64_t i = 0; i < total; ++i) out[i] += dc_shift;
    if (scale != 1.0f)
        for (int64_t i = 0; i < total; ++i) out[i] *= scale;
    if (noise_level != 0.0f) {
        uint32_t st = seed;
        const float inv = 1.0f / 2147483647.0f;
        for (int64_t i = 0; i < total; ++i)
            out[i] += noise_level * 2.0f *
                      (static_cast<float>(pn_lcg(&st)) * inv - 0.5f);
    }
    return n;
}

// ---------------------------------------------------------------------------
// Big-endian <-> host byte swaps for HTK parameter files (matrix.h:2576-2590).
// ---------------------------------------------------------------------------
PN_EXPORT void pn_swap4(uint8_t* data, int64_t n_words) {
    for (int64_t i = 0; i < n_words; ++i) {
        uint8_t* p = data + 4 * i;
        uint8_t t = p[0]; p[0] = p[3]; p[3] = t;
        t = p[1]; p[1] = p[2]; p[2] = t;
    }
}

PN_EXPORT void pn_swap2(uint8_t* data, int64_t n_words) {
    for (int64_t i = 0; i < n_words; ++i) {
        uint8_t* p = data + 2 * i;
        uint8_t t = p[0]; p[0] = p[1]; p[1] = t;
    }
}

// ---------------------------------------------------------------------------
// Phoneme-loop Viterbi backtrack over the device-produced history arrays
// (full-history replay of PhnDec::Done, phndec.cpp:236-302).  Batched: each
// row b has hist arrays of logical length n_frames[b] laid out with stride
// max_t.  Segments are written REVERSED (latest first) into per-row slots of
// capacity `cap`; the Python wrapper re-reverses.  Returns 0, or -1 if any
// row overflowed cap.
// Segment like = alpha[end-1] - alpha[start-1] (alpha[-1] := 0, phndec.cpp:91).
// ---------------------------------------------------------------------------
PN_EXPORT int32_t pn_backtrack_batch(
    const int32_t* max_phn, const int32_t* prev_phn, const int32_t* length,
    const float* alpha, const int32_t* n_frames, int64_t batch, int64_t max_t,
    int32_t* out_start, int32_t* out_end, int32_t* out_phn, float* out_like,
    int32_t* out_count, int64_t cap) {
    int32_t status = 0;
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t base = b * max_t;
        const int64_t obase = b * cap;
        int64_t t = n_frames[b];
        int32_t k = 0;
        int32_t phn = (t > 0) ? max_phn[base + t - 1] : -1;
        while (t > 0 && phn != -1) {
            int32_t seg_len = length[base + t - 1];
            int64_t start = t - seg_len;
            if (start < 0) start = 0;
            float prev_alpha = (start > 0) ? alpha[base + start - 1] : 0.0f;
            if (k >= cap) { status = -1; break; }
            out_start[obase + k] = static_cast<int32_t>(start);
            out_end[obase + k] = static_cast<int32_t>(t);
            out_phn[obase + k] = phn;
            out_like[obase + k] = alpha[base + t - 1] - prev_alpha;
            ++k;
            phn = prev_phn[base + t - 1];
            t = start;
        }
        out_count[b] = k;
    }
    return status;
}

// ---------------------------------------------------------------------------
// Minimum-edit-cost alignment with HTK HResults costs (sub 10, ins 7, del 7;
// STKLib/labels.C:525-527).  Inputs are integer symbol ids.  Outputs
// {H, D, S, I} per pair.  Backpointer tie order matches score.py: prefer
// diagonal, then deletion, then insertion.
// ---------------------------------------------------------------------------
PN_EXPORT void pn_align(const int32_t* ref, int32_t n_ref,
                        const int32_t* hyp, int32_t n_hyp,
                        int32_t* out_hdsi) {
    const int32_t SUB = 10, INS = 7, DEL = 7;
    const int64_t W = n_hyp + 1;
    std::vector<int32_t> cost((n_ref + 1) * W);
    std::vector<uint8_t> back((n_ref + 1) * W);  // 0=diag 1=del 2=ins
    for (int32_t i = 1; i <= n_ref; ++i) {
        cost[i * W] = i * DEL;
        back[i * W] = 1;
    }
    for (int32_t j = 1; j <= n_hyp; ++j) {
        cost[j] = j * INS;
        back[j] = 2;
    }
    for (int32_t i = 1; i <= n_ref; ++i) {
        for (int32_t j = 1; j <= n_hyp; ++j) {
            int32_t sub = cost[(i - 1) * W + (j - 1)] +
                          ((ref[i - 1] == hyp[j - 1]) ? 0 : SUB);
            int32_t del = cost[(i - 1) * W + j] + DEL;
            int32_t ins = cost[i * W + (j - 1)] + INS;
            int32_t best = sub;
            uint8_t bp = 0;
            if (del < best) { best = del; bp = 1; }
            if (ins < best) { best = ins; bp = 2; }
            cost[i * W + j] = best;
            back[i * W + j] = bp;
        }
    }
    int32_t h = 0, d = 0, s = 0, ins_n = 0;
    int32_t i = n_ref, j = n_hyp;
    while (i > 0 || j > 0) {
        uint8_t bp = back[i * W + j];
        if (i > 0 && j > 0 && bp == 0) {
            if (ref[i - 1] == hyp[j - 1]) ++h; else ++s;
            --i; --j;
        } else if (i > 0 && (bp == 1 || j == 0)) {
            ++d; --i;
        } else {
            ++ins_n; --j;
        }
    }
    out_hdsi[0] = h; out_hdsi[1] = d; out_hdsi[2] = s; out_hdsi[3] = ins_n;
}

// Batched alignment over concatenated sequences with offset tables.
PN_EXPORT void pn_align_batch(const int32_t* refs, const int64_t* ref_off,
                              const int32_t* hyps, const int64_t* hyp_off,
                              int64_t n_pairs, int32_t* out_hdsi) {
    for (int64_t p = 0; p < n_pairs; ++p) {
        pn_align(refs + ref_off[p],
                 static_cast<int32_t>(ref_off[p + 1] - ref_off[p]),
                 hyps + hyp_off[p],
                 static_cast<int32_t>(hyp_off[p + 1] - hyp_off[p]),
                 out_hdsi + 4 * p);
    }
}

PN_EXPORT int32_t pn_abi_version(void) { return 1; }
