"""Plain reference of an LCRC phoneme recognizer with a phoneme-loop
decoder (BUT PhnRec's LCRC packages), in torch and NumPy, for judging
what the program produced.

It reads the package's raw files (config sizes come from the benchmark's
configuration file, weights and windows from the package directory the
benchmark wrote) and computes, one utterance at a time:

    int16 samples -> Hamming-windowed frames (vector_size, vector_step)
    -> |DFT|^2 over nfft/2 bins -> triangular mel banks -> ln (0 for <= 0)
    -> [sentence mean norm, or online mean norm: the mean of the first E
    frames taken from frame E - 1 on] -> LCRC: 31-frame context, edges replicated,
    each half (16 frames) times its window and a DCT with C0, bank-major
    -> two band nets and a merger net on ln of their outputs, each
    (x - mean) * dev -> sigmoid -> softmax with the ICSI fast exp
    -> ln -> phoneme-loop Viterbi (S states a phoneme, self-loop and
    advance log 0.5, the insertion penalty on every entry and at t = 0)

``Reference(..., control=False)`` computes in float64.  With
``control=True`` it computes the posteriors in float32 with every
product's operands rounded to TF32 (10 mantissa bits), the precision a
later change would be tempted to take; the phoneme loop stays in
float64, so that the control differs from the reference in its products
alone.  It then stands in the program's place and its labels come from
``decode``.

``judge`` holds a program's labels of one utterance to the float64
reference: the gap between the best path score and the score of the
program's own path (its phonemes and boundaries, the best state
alignment inside each label), and the widest distance, over the path's
runs of one phoneme, between the sum of the label scores the program
reported for the run and the run's reference score.  A path that does not tile the utterance, or
names a phoneme the package lacks, scores -inf.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

LOG_HALF = float(np.log(0.5))
# the ICSI fast exp (fexp.h): t = trunc_sat_int32(A y) + K, 2^e (1 + m)
FEXP_A = 1048576 / 0.69314718055994530942
FEXP_K = 1072693248 - 60801


def read_nbin(path: str) -> Dict[str, np.ndarray]:
    """One net of a .nbin file: int32 nlayers, n_inp, n_hid, n_out, then
    float32 W1 [hid16][inp16], W2 [out16][hid16], b1, b2, mean, dev, each
    dimension padded to a multiple of 4."""
    with open(path, "rb") as f:
        data = f.read()
    nl, ni, nh, no = struct.unpack_from("<4i", data, 0)
    if nl != 2:
        raise ValueError(f"{path}: {nl} layers")
    pad = [(n + 3) & ~3 for n in (ni, nh, no)]
    i16, h16, o16 = pad
    off, out = 16, []
    for count in (h16 * i16, o16 * h16, h16, o16, i16, i16):
        out.append(np.frombuffer(data, "<f4", count, off).astype(np.float64))
        off += 4 * count
    return dict(w1=out[0].reshape(h16, i16)[:nh, :ni],
                w2=out[1].reshape(o16, h16)[:no, :nh],
                b1=out[2][:nh], b2=out[3][:no], mean=out[4][:ni],
                dev=out[5][:ni])


def mel_matrix(fs: int, nfft: int, nbanks: int, lo: float, hi: float
               ) -> np.ndarray:
    """[nfft/2, nbanks] triangular filters, centres equally spaced in mel
    (1127 ln(1 + f / 700)) between lo and hi; bin i between centres
    ch - 1 and ch gives (c, 1 - c) to the two banks."""
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    lo, hi = max(lo, 0.0), min(hi, fs / 2.0)
    bf = fs / nfft
    mlo, mhi = mel(lo), mel(hi)
    first, last = max(int(lo / bf + 1.5), 1), min(int(hi / bf - 0.5),
                                                  nfft // 2 - 1)
    centres = mlo + (mhi - mlo) / (nbanks + 1) * np.arange(1, nbanks + 2)
    A = np.zeros((nfft // 2, nbanks))
    for i in range(first, last + 1):
        m = mel(i * bf)
        ch = 0
        while ch <= nbanks and m > centres[ch]:
            ch += 1
        left = mlo if ch == 0 else centres[ch - 1]
        c = (centres[ch] - m) / (centres[ch] - left)
        if ch > 0:
            A[i, ch - 1] += c
        if ch < nbanks:
            A[i, ch] += 1.0 - c
    return A


def dct_c0(n: int, n_coefs: int) -> np.ndarray:
    """[n, n_coefs]: C0 then DCT_1.., each scaled by sqrt(2 / n)."""
    j = np.arange(n)
    cols = [np.full(n, 1.0)] + [np.cos(np.pi / n * k * (j + 0.5))
                                for k in range(1, n_coefs)]
    return np.sqrt(2.0 / n) * np.stack(cols, 1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """The package's model in float64, or the TF32 control."""

    def __init__(self, cfg: dict, package: str, device, control=False):
        self.cfg, self.device, self.control = cfg, torch.device(device), \
            control
        self.dtype = torch.float32 if control else torch.float64
        P, S = cfg["n_phonemes"], cfg["n_states"]
        self.P, self.S, self.wpen = P, S, float(cfg["wpenalty"])
        with open(os.path.join(package, "phonemes")) as f:
            self.phonemes = [line.rstrip("\r\n") for line in f if
                             line.strip()]
        vs = cfg["vector_size"]
        nfft = 1 << (vs - 1).bit_length()
        n = np.arange(vs)[:, None]
        ang = -2.0 * np.pi * n * np.arange(nfft // 2)[None, :] / nfft
        ham = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(vs) / (vs - 1))
        self.dft = self._t(ham[:, None] * np.concatenate(
            [np.cos(ang), np.sin(ang)], 1))
        self.mel = self._t(mel_matrix(cfg["sample_freq"], nfft,
                                      cfg["nbanks"], cfg["lower_freq"],
                                      cfg["higher_freq"]))
        half = (cfg["trap_len"] - 1) // 2 + 1
        M = dct_c0(half, cfg["n_coefs"])
        self.taps = []
        for i in range(2):
            with open(os.path.join(package, "windows",
                                   f"band{i}.window")) as f:
                w = np.array(f.read().split()[:half], np.float64)
            self.taps.append(self._t(w[:, None] * M))
        self.nets = [{k: self._t(v) for k, v in read_nbin(
            os.path.join(package, "weights", f"{name}.nbin")).items()}
            for name in ("band0", "band1", "merger")]

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            self.device, self.dtype)

    def _mm(self, a, b) -> torch.Tensor:
        if self.control:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def _fexp(self, y: torch.Tensor) -> torch.Tensor:
        v = (FEXP_A * y).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
        t = v.to(torch.int64) + FEXP_K
        t = ((t + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31           # int32 wrap
        e = (t >> 20) - 1023
        m = (t & 0xFFFFF).to(self.dtype) / 1048576.0
        p = torch.pow(torch.tensor(2.0, dtype=self.dtype,
                                   device=y.device), e.clamp(-126, 128)
                      .to(self.dtype))
        p = torch.where(e <= -126, 0.0, torch.where(e >= 128, float("inf"),
                                                     p))
        return p * (1.0 + m)

    def _net(self, x: torch.Tensor, net: dict) -> torch.Tensor:
        xn = (x - net["mean"]) * net["dev"]
        h = 1.0 / (1.0 + self._fexp(-(self._mm(xn, net["w1"].T)
                                      + net["b1"])))
        o = self._mm(h, net["w2"].T) + net["b2"]
        e = self._fexp(o - o.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True)

    def features(self, wave: np.ndarray, sent_norm: bool,
                 online_mean: int = 0) -> torch.Tensor:
        """int16 samples -> [T, nbanks] log mel, mean-normed over the
        utterance if asked; with ``online_mean`` E, the mean of the first
        E frames is taken from frame E - 1 on, earlier frames pass as
        they are."""
        cfg = self.cfg
        vs, st = cfg["vector_size"], cfg["vector_step"]
        x = self._t(wave.astype(np.float64))
        T = 1 if len(wave) <= vs else (len(wave) - vs) // st + 1
        idx = (torch.arange(T, device=self.device)[:, None] * st
               + torch.arange(vs, device=self.device)[None, :])
        frames = x[idx.clamp(max=len(wave) - 1)]
        ri = self._mm(frames, self.dft)
        re, im = ri.chunk(2, dim=1)
        en = self._mm(re * re + im * im, self.mel)
        par = torch.where(en > 0, torch.log(en.clamp(min=1e-300)), 0.0)
        if sent_norm:
            par = par - par.mean(0, keepdim=True)
        if online_mean:
            mean = par[:online_mean].sum(0, keepdim=True) / online_mean
            par = torch.cat([par[: online_mean - 1],
                             par[online_mean - 1:] - mean])
        return par

    def log_posteriors(self, wave: np.ndarray, sent_norm: bool,
                       online_mean: int = 0, block: int = 32768
                       ) -> np.ndarray:
        """int16 samples of one utterance -> [T, P*S] float64 log
        posteriors (in blocks of frames, so a long stream fits)."""
        par = self.features(wave, sent_norm, online_mean)
        T, nb = par.shape
        shift = (self.cfg["trap_len"] - 1) // 2
        p3 = torch.cat([par[:1].expand(shift, nb), par,
                        par[-1:].expand(shift, nb)])
        out = []
        for t0 in range(0, T, block):
            win = p3[t0: min(T, t0 + block) + 2 * shift].unfold(
                0, 2 * shift + 1, 1)                  # [n, nb, 31]
            sides = [self._mm(win[:, :, j: j + shift + 1],
                              self.taps[i]).reshape(win.shape[0], -1)
                     for i, j in ((0, 0), (1, shift))]
            lo, ro = (self._net(s, n) for s, n in zip(sides, self.nets))
            m = torch.cat([lo, ro], -1)
            m = torch.where(m > 0, torch.log(m.clamp(min=1e-300)), 0.0)
            out.append(torch.log(self._net(m, self.nets[2])))
        return torch.cat(out).double().cpu().numpy()

    # -- the phoneme loop --------------------------------------------------
    def _obs(self, lps: Sequence[np.ndarray]) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        T = np.array([lp.shape[0] for lp in lps])
        obs = np.zeros((len(lps), T.max(), self.P, self.S))
        for b, lp in enumerate(lps):
            obs[b, : T[b]] = lp[:, : self.P * self.S].reshape(
                -1, self.P, self.S)
        return obs, T

    def best_scores(self, lps: Sequence[np.ndarray]) -> np.ndarray:
        """The best path score of each utterance: the highest exit of any
        phoneme at its last frame."""
        return self._viterbi(lps, history=False)

    def decode(self, lps: Sequence[np.ndarray]
               ) -> List[List[Tuple[int, int, str, float]]]:
        """The best path of each utterance as labels (start, end, name,
        score), scores the path's score differences at label ends; ties
        go to the advancing token and to the lowest phoneme."""
        return self._viterbi(lps, history=True)

    def _viterbi(self, lps, history: bool):
        obs, T = self._obs(lps)
        B, P, S = obs.shape[0], self.P, self.S
        f = np.float64
        a = np.full((B, P, S + 1), -np.inf, f)
        a[:, :, 0] = self.wpen
        ent = np.zeros((B, P, S + 1), np.int64)
        best = np.zeros(B)
        hist = [] if history else None
        for t in range(obs.shape[1]):
            cur, prev = a[:, :, 1:] + f(LOG_HALF), a[:, :, :-1] + f(LOG_HALF)
            take = cur > prev
            new = np.where(take, cur, prev) + obs[:, t]
            k = np.argmax(new[:, :, -1], axis=1)
            top = new[np.arange(B), k, -1]
            live = (t < T)[:, None, None]
            na = np.concatenate([np.broadcast_to(
                (top + f(self.wpen))[:, None, None], (B, P, 1)), new], 2)
            a = np.where(live, na, a)
            if history:
                ne = np.where(take, ent[:, :, 1:], ent[:, :, :-1])
                hist.append((k, ne[np.arange(B), k, -1], top))
                ent = np.where(live, np.concatenate(
                    [np.full((B, P, 1), t + 1), ne], 2), ent)
            best = np.where(t == T - 1, top, best)
        if not history:
            return best
        out = []
        for b in range(B):
            labels, end = [], int(T[b])
            while end > 0:
                k, start, alpha = (h[b] for h in hist[end - 1])
                prev = float(hist[start - 1][2][b]) if start > 0 else 0.0
                labels.append((int(start), end, self.phonemes[int(k)],
                               float(alpha) - prev))
                end = int(start)
            out.append(labels[::-1])
        return out

    def path_scores(self, lps: Sequence[np.ndarray],
                    labels: Sequence[Sequence[Tuple[int, int, str, float]]]
                    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """The score of each utterance's given path: its labels' phonemes
        and boundaries, the best alignment of the S states inside each
        label (two labels of one phoneme in a row may also be one
        occurrence); and the path's score up to the end of each run of
        labels of one phoneme, where the path has to leave the phoneme.
        -inf where the labels do not tile [0, T) or name an unknown
        phoneme."""
        obs, T = self._obs(lps)
        B, S = obs.shape[0], self.S
        index = {p: i for i, p in enumerate(self.phonemes)}
        ph = np.zeros(obs.shape[:2], np.int64)
        start = np.zeros(obs.shape[:2], bool)
        end = np.zeros(obs.shape[:2], bool)
        ok = np.ones(B, bool)
        for b, labs in enumerate(labels):
            pos = 0
            for s, e, name, _ in labs:
                if s != pos or e <= s or e > T[b] or name not in index:
                    ok[b] = False
                    break
                ph[b, s:e], start[b, s], end[b, e - 1] = index[name], 1, 1
                pos = e
            ok[b] &= pos == T[b]
        # a run of one phoneme ends where the next frame's phoneme differs,
        # and at the utterance's last frame
        last = np.arange(obs.shape[1])[None, :] == T[:, None] - 1
        run_end = end & (np.concatenate(
            [ph[:, 1:] != ph[:, :-1], np.ones((B, 1), bool)], 1) | last)
        at_run_end = []
        a = np.full((B, S), -np.inf)
        exit_ = np.zeros(B)
        rows = np.arange(B)
        for t in range(obs.shape[1]):
            o = obs[rows, t, ph[:, t]]                        # [B, S]
            stay = a + LOG_HALF
            adv = np.concatenate([np.full((B, 1), -np.inf), a[:, :-1]],
                                 1) + LOG_HALF
            go_on = np.maximum(stay, adv)
            enter = np.full((B, S), -np.inf)
            enter[:, 0] = exit_ + self.wpen + LOG_HALF
            # a label that goes on with the phoneme before it may be one
            # occurrence split in two (the fixed-lag commit splits a label
            # that spans its horizon): it scores as either
            if t > 0:
                enter = np.where((ph[:, t] == ph[:, t - 1])[:, None],
                                 np.maximum(enter, go_on), enter)
            a = np.where(start[:, t, None], enter, go_on) + o
            exit_ = np.where(end[:, t], a[:, -1], exit_)
            at_run_end.append(exit_.copy())
        at_run_end = np.stack(at_run_end, 1)              # [B, T]
        runs = [at_run_end[b, : T[b]][run_end[b, : T[b]]] for b in range(B)]
        return np.where(ok, exit_, -np.inf), runs


def judge(ref: Reference, lps: Sequence[np.ndarray], labels) -> dict:
    """The widest path gap and run score error over the utterances, in
    nats (1e30 stands for a path that scores -inf)."""
    best = ref.best_scores(lps)
    mine, runs = ref.path_scores(lps, labels)
    gap = np.where(np.isfinite(mine), best - mine, 1e30)
    run_err = 0.0
    for labs, ends, ok in zip(labels, runs, np.isfinite(mine)):
        if not ok:
            run_err = 1e30
            continue
        # the reported scores summed up to each run's end
        cum, at = [], 0.0
        for i, lab in enumerate(labs):
            at += lab[3]
            if i + 1 == len(labs) or labs[i + 1][2] != lab[2]:
                cum.append(at)
        d = np.diff(np.concatenate([[0.0], cum])) - np.diff(
            np.concatenate([[0.0], ends]))
        run_err = max(run_err, float(np.abs(d).max(initial=0.0)))
    return dict(path_gap_nats=float(gap.max(initial=0.0)),
                run_err_nats=run_err,
                labels=int(sum(map(len, labels))))
