"""Synthetic LCRC model packages and audio, made from a seed.

``write_lcrc_package`` writes a model package in the reference's on-disk
formats (config, phoneme list, ``weights/*.nbin``, ``windows/*.window``)
that both phnrec_tpu.SpeechRec and phnrec_tpu_torch.SpeechRec load.  Three
shapes:

* ``"cz"``: the flagship CZ SpeechDat LCRC package's shapes — 15 mel banks
  at 8 kHz, sentence mean norm, band nets 165->1500->138 (x2), merger
  276->1500->138, a 46-phoneme x 3-state loop, wpenalty -4.6875;
* ``"en"``: the EN TIMIT LCRC N500 package's shapes — 23 mel banks at
  16 kHz (vector 400, step 160), no sentence norm, band nets
  253->500->120 (x2), merger 240->500->120, 40 phonemes x 3 states,
  wpenalty -2.03125;
* ``"tiny"``: 5 banks, 4 phonemes x 3 states, hidden 32, for tests.

``write_lcrc_package(..., plp=True)`` gives the package the PLP frontend
(params/kind=plp, order 12) in place of the log mel banks: 12 mel banks
(the estimator's input width is melbanks/nbanks, so it must equal the PLP
order) and band nets sized to 12-wide params (12 x 11 inputs).
``write_traps_package`` writes the other posterior systems at a shape's
widths, Hamming-windowed trajectories of 31 frames: ``"3BT"`` (band nets
31->n_hid->n_out for all but the top two banks, the merger over their
concatenated outputs: 13 x 138 = 1,794 inputs at the CZ shapes),
``"1BT"`` (every bank: 2,070) and ``"1BT_DCT"`` (no band nets, 11 DCT
coefficients a bank into the merger: 165).

``write_stk_decode_package`` turns such a package into an stkint decode
package (decoder/type=stkint, mode=decode) over the phoneme loop that
netgen generates at load time from the phoneme list, with one HMM of 3
states a phoneme: the configuration of benchmarks/stkint_batch.py.

``write_kws_package`` turns such a package into an stkint keyword-spotting
package (decoder/type=stkint, mode=kws): a keyword list and lexicon, and
the HMM set and KWS network generated at load time by netgen, as the
reference does.  ``"en"`` spots ``greasy`` (g r iy s iy) and ``wash``
(w aa sh), the repo's KWS serving configuration
(benchmarks/long_audio.py:56-88); ``"tiny"`` spots ``alpha`` and ``beta``;
or a given number of generated keywords.  Both stkint writers can give the
HMM set a global <InputXform> (a delay line: a stacking node under a
linear one).

``write_gmm_models`` writes a seeded DiagC HMM set (one left-to-right
HMM a phoneme, mixtures of diagonal Gaussians around a given mean and
spread) for training on feature files.

The weights are random.  W1 is scaled so hidden pre-activations stay
within about +-20 for unit-variance inputs, b2 cancels each output's mean
drive from the hidden layer, and each net's input ``mean``/``dev`` are
measured on a seeded batch of ``synth_audio`` run through the port's own
frontend and LCRC assembly on the CPU.  The decode then finds several
distinct phonemes per utterance.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from phnrec_tpu_torch.io.audio import ALAW_TABLE_D5
from phnrec_tpu_torch.io.weights import MLPParams, save_nbin

# 40 TIMIT-style phoneme names, among them those of the EN keywords
EN_PHONEMES = ("aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k l m n "
               "ng ow oy p r s sh t th uh uw v w y z zh sil").split()
_8K = dict(fs=8000, vector_size=200, vector_step=80, sent_norm="true",
           wpenalty=-4.6875)
SHAPES = {
    "cz": dict(nbanks=15, n_phonemes=46, n_hid=1500, **_8K),
    "en": dict(nbanks=23, n_phonemes=40, n_hid=500, fs=16000,
               vector_size=400, vector_step=160, sent_norm="false",
               wpenalty=-2.03125, phonemes=EN_PHONEMES),
    "tiny": dict(nbanks=5, n_phonemes=4, n_hid=32, **_8K),
}
KEYWORDS = {
    "en": {"greasy": "g r iy s iy", "wash": "w aa sh"},
    "tiny": {"alpha": "ph00 ph01 ph02", "beta": "ph03 ph01"},
}
N_STATES = 3
N_COEFS = 11    # DCT coefficients a bank: LCRC C0 + 10, 1BT_DCT 11
TRAP_LEN = 31
PLP_ORDER = 12

CONFIG = """\
[source]
format={fmt}
sample_freq={fs}
[melbanks]
nbanks={nbanks}
lower_freq=64
higher_freq={hi}
vector_size={vector_size}
vector_step={vector_step}
[offlinenorm]
sent_mean_norm={sent_norm}
[posteriors]
enabled=true
system={system}
length={trap_len}
hamming=true
add_c0={add_c0}
softening_func=none 0 0 0
[decoder]
type=phndec
num_states_per_phn={n_states}
wpenalty={wpenalty}
softening_func=log 0 0 0
[dicts]
phoneme_list=$C/phonemes
"""

# the stkint KWS lines of benchmarks/long_audio.py:81-84, plus generated
# models: a synthetic package ships no tmp/models
KWS_CONFIG = """\
[decoder]
mode=kws
[networks]
gen_kws_net=true
default=$T/kwsnet
[dicts]
keyword_list=$C/kwlist
lexicon1=$C/kwlex
[models]
gen_from_phn_list=true
hmm_defs=$T/models
"""


# the stkint decode lines: HMMs and a phoneme-loop network generated from
# the phoneme list at load time (netgen.cpp), as benchmarks/stkint_batch.py
# builds them
STK_DECODE_CONFIG = """\
[decoder]
mode=decode
[networks]
gen_phn_loop=true
default=$T/phnloop
[models]
gen_from_phn_list=true
hmm_defs=$T/models
"""


def write_gmm_models(path, phonemes: Sequence[str], n_states: int = 3,
                     n_mix: int = 8, dim: int = 45, seed: int = 0,
                     mean=None, std=None) -> str:
    """Write a seeded DiagC MMF at ``path``: one HMM a phoneme with
    ``n_states`` emitting states of ``n_mix`` mixtures over ``dim`` dims
    and netgen's 0.5/0.5 left-to-right transitions; mixture means
    ``mean`` + N(0, 1) ``std``, variances ``std``^2 U(0.5, 1.5), weights
    from a flat Dirichlet.  Returns the path."""
    rng = np.random.default_rng(seed)
    mean = np.zeros(dim) if mean is None else np.asarray(mean, np.float64)
    std = np.ones(dim) if std is None else np.asarray(std, np.float64)
    fmt = lambda v: " ".join(f"{x:.6e}" for x in v)  # noqa: E731
    N = n_states + 2
    lines = [f"~o <VecSize> {dim} <DIAGC>"]
    for name in phonemes:
        lines += [f'~h "{name}"', "<BeginHMM>", f"<NumStates> {N}"]
        for i in range(n_states):
            w = rng.dirichlet(np.ones(n_mix))
            lines.append(f"<State> {i + 2} <NumMixes> {n_mix}")
            for k in range(n_mix):
                mu = mean + rng.standard_normal(dim) * std
                var = std * std * rng.uniform(0.5, 1.5, dim)
                lines += [f"<Mixture> {k + 1} {w[k]:.6e}",
                          f"<Mean> {dim}", fmt(mu), f"<Variance> {dim}",
                          fmt(var)]
        lines.append(f"<TransP> {N}")
        for i in range(N):
            row = np.zeros(N)
            if i == 0:
                row[1] = 1.0
            elif i < N - 1:
                row[i] = row[i + 1] = 0.5
            lines.append(fmt(row))
        lines.append("<EndHMM>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def synth_audio(rng: np.random.Generator, n_samples: int,
                fs: int = 8000) -> np.ndarray:
    """Speech-like int16 audio: 40-200 ms segments, each a few random
    tones plus noise at a random level, so the spectrum changes over
    time."""
    out = np.zeros(n_samples, np.float64)
    pos = 0
    while pos < n_samples:
        n = min(int(rng.integers(fs // 25, fs // 5)), n_samples - pos)
        t = np.arange(n) / fs
        seg = rng.standard_normal(n) * rng.uniform(0.05, 0.5)
        for f, a in zip(rng.uniform(100, 3600, 3), rng.uniform(0, 1, 3)):
            seg += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        out[pos: pos + n] = seg * rng.uniform(200, 6000)
        pos += n
    return np.clip(out, -32768, 32767).astype(np.int16)


def alaw_encode(x: np.ndarray) -> np.ndarray:
    """Nearest A-law code of each float sample under the decode table
    (8 * ALAW_TABLE_D5)."""
    table = 8.0 * ALAW_TABLE_D5.astype(np.float64)
    order = np.argsort(table)
    sorted_t = table[order]
    i = np.clip(np.searchsorted(sorted_t, x), 1, len(sorted_t) - 1)
    left_closer = np.abs(x - sorted_t[i - 1]) <= np.abs(sorted_t[i] - x)
    return order[np.where(left_closer, i - 1, i)].astype(np.uint8)


def write_audio_files(directory, n_files: int, seconds: Sequence[float],
                      seed: int, fmt: str = "lin16") -> List[str]:
    """``n_files`` raw files (lin16 or alaw) of uniform random length in
    ``seconds`` = (lo, hi); returns their paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        n = int(rng.uniform(*seconds) * 8000)
        x = synth_audio(rng, n)
        data = x.astype("<i2").tobytes() if fmt == "lin16" else \
            alaw_encode(x.astype(np.float64)).tobytes()
        p = os.path.join(str(directory), f"utt{i:04d}.raw")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    return paths


def _net(rng, n_inp, n_hid, n_out) -> MLPParams:
    w1 = rng.standard_normal((n_hid, n_inp)) * (4.0 / np.sqrt(n_inp))
    w2 = rng.standard_normal((n_out, n_hid)) * (8.0 / np.sqrt(n_hid))
    return MLPParams(
        w1=w1.astype(np.float32),
        b1=(rng.standard_normal(n_hid) * 0.5).astype(np.float32),
        w2=w2.astype(np.float32),
        b2=(-0.5 * w2.sum(1)).astype(np.float32),
        mean=np.zeros(n_inp, np.float32),
        dev=np.ones(n_inp, np.float32))


def _norm_of(feats: torch.Tensor) -> tuple:
    f = feats.reshape(-1, feats.shape[-1]).double().numpy()
    return (f.mean(0).astype(np.float32),
            (1.0 / np.maximum(f.std(0), 1e-3)).astype(np.float32))


def write_lcrc_package(root, shape: str = "tiny", seed: int = 0,
                       fmt: str = "lin16", sent_norm=None,
                       plp: bool = False) -> str:
    """Write a synthetic LCRC package under ``root``; returns its path.
    ``sent_norm`` (a bool) overrides the shape's sentence mean norm: the
    streaming paths apply none, so a package measured without it suits
    them.  ``plp`` selects the PLP frontend (order 12, 12 mel banks)."""
    return _write_package(root, shape, seed, fmt, sent_norm, "LCRC", plp)


def write_traps_package(root, system: str, shape: str = "cz",
                        seed: int = 0, fmt: str = "lin16",
                        sent_norm=None) -> str:
    """Write a synthetic 3BT, 1BT or 1BT_DCT package under ``root``;
    returns its path.  ``sent_norm`` as for write_lcrc_package."""
    if system not in ("3BT", "1BT", "1BT_DCT"):
        raise ValueError(f"no traps system {system!r}")
    return _write_package(root, shape, seed, fmt, sent_norm, system, False)


def _write_package(root, shape, seed, fmt, sent_norm, system, plp) -> str:
    dims = dict(SHAPES[shape])
    if sent_norm is not None:
        dims["sent_norm"] = "true" if sent_norm else "false"
    if plp:
        dims["nbanks"] = PLP_ORDER
    nb, P, H = dims["nbanks"], dims["n_phonemes"], dims["n_hid"]
    fs = dims["fs"]
    n_out = P * N_STATES
    root = Path(root)
    (root / "weights").mkdir(parents=True, exist_ok=True)
    config = CONFIG.format(
        fmt=fmt, nbanks=nb, trap_len=TRAP_LEN, n_states=N_STATES,
        fs=fs, hi=fs // 2, system=system,
        add_c0="true" if system == "LCRC" else "false",
        **{k: dims[k] for k in ("vector_size", "vector_step", "sent_norm",
                                "wpenalty")})
    if plp:
        config += f"[params]\nkind=plp\n[plp]\norder={PLP_ORDER}\n"
    (root / "config").write_text(config)
    names = dims.get("phonemes") or [f"ph{i:02d}" for i in range(P)]
    (root / "phonemes").write_text("".join(f"{p}\n" for p in names))

    rng = np.random.default_rng(seed)
    if system == "LCRC":
        (root / "windows").mkdir(exist_ok=True)
        ham = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(TRAP_LEN)
                                   / (TRAP_LEN - 1))
        half = (TRAP_LEN - 1) // 2
        for i, win in enumerate((ham[: half + 1], ham[half:])):
            (root / "windows" / f"band{i}.window").write_text(
                " ".join(f"{v:.8f}" for v in win) + "\n")
        bands = [_net(rng, nb * N_COEFS, H, n_out) for _ in range(2)]
        merger = _net(rng, 2 * n_out, H, n_out)
    elif system == "1BT_DCT":
        bands = []
        merger = _net(rng, nb * N_COEFS, H, n_out)
    else:
        n_bands = nb - 2 if system == "3BT" else nb
        bands = [_net(rng, TRAP_LEN, H, n_out) for _ in range(n_bands)]
        merger = _net(rng, n_bands * n_out, H, n_out)
    for i, p in enumerate(bands):
        save_nbin(str(root / "weights" / f"band{i}.nbin"), p)
    save_nbin(str(root / "weights" / "merger.nbin"), merger)

    # measure input norms on seeded audio through the port on the CPU
    from phnrec_tpu_torch import normalization
    from phnrec_tpu_torch.pipeline import SpeechRec
    from phnrec_tpu_torch.posteriors.stc import clamped_context
    sr = SpeechRec(str(root), device="cpu")
    bp = sr.batch_pipeline
    waves = [synth_audio(rng, fs * 3, fs) for _ in range(4)]
    wave, n_samples = bp.pad_batch(waves)
    w, nf, max_frames, _ = bp.to_device(wave.astype(np.int16), n_samples)
    est = sr.estimator
    with torch.inference_mode():
        par = sr.frontend(bp.convert_wave(w), max_frames)
        par = normalization.sentence_norm(par, sr.sent_norm, n_valid=nf)
        if system == "LCRC":
            band_in = sr.estimator.assembler.batched(par, nf)
        else:
            ctx = clamped_context(par, TRAP_LEN, nf)
            band_in = (ctx[..., i] * est.window for i in range(len(bands)))
        outs = []
        for i, feats in enumerate(band_in):
            bands[i].mean, bands[i].dev = _norm_of(feats)
            save_nbin(str(root / "weights" / f"band{i}.nbin"), bands[i])
            x = (feats - torch.from_numpy(bands[i].mean)) * \
                torch.from_numpy(bands[i].dev)
            h = torch.sigmoid(x @ torch.from_numpy(bands[i].w1.T)
                              + torch.from_numpy(bands[i].b1))
            o = h @ torch.from_numpy(bands[i].w2.T) + \
                torch.from_numpy(bands[i].b2)
            outs.append(torch.log_softmax(o, dim=-1))
        if system == "1BT_DCT":
            m = est.merger_input(clamped_context(par, TRAP_LEN, nf))
        else:
            m = torch.cat(outs, dim=-1)
            m = m if system == "LCRC" else -m
        merger.mean, merger.dev = _norm_of(m)
    save_nbin(str(root / "weights" / "merger.nbin"), merger)
    return str(root)


def _keywords(shape: str, n_keywords, seed: int) -> dict:
    """The shape's keywords, or ``n_keywords`` generated ones: kw000,
    kw001, ... of 4-6 seeded phonemes of the shape's list each."""
    if n_keywords is None:
        return KEYWORDS[shape]
    dims = SHAPES[shape]
    names = dims.get("phonemes") or [f"ph{i:02d}"
                                     for i in range(dims["n_phonemes"])]
    names = [p for p in names if p != "sil"]
    rng = np.random.default_rng(seed + 7919)
    return {f"kw{i:03d}": " ".join(rng.choice(names, rng.integers(4, 7)))
            for i in range(n_keywords)}


def _input_xform_mmf(D: int) -> str:
    """A global <InputXform> over D-dim observations: a stacking node of 2
    frames under a linear one, y_t = 0.2 x_{t-1} + 0.8 x_t (delay 1)."""
    m = np.concatenate([0.2 * np.eye(D), 0.8 * np.eye(D)], axis=1)
    rows = "\n".join(" ".join(f"{v:g}" for v in r) for r in m)
    return (f'~j "stack2" <VecSize> {2 * D} <Stacking> 2 {D}\n'
            f'<InputXform> <Input> ~j "stack2" <VecSize> {D} '
            f"<Xform> {D} {2 * D}\n{rows}\n")


def _stkint_package(root, shape: str, seed: int, extra: str, sent_norm,
                    input_xform: bool, system: str = "LCRC") -> Path:
    """The ``system`` package of ``shape`` (LCRC, 3BT, 1BT or 1BT_DCT) as
    an stkint package with the config lines ``extra``.  With
    ``input_xform`` the HMM set is written here (the phoneme-list HMMs
    netgen generates, then ``_input_xform_mmf``) instead of at load
    time."""
    from phnrec_tpu_torch.netgen import phn_list_to_hmm_defs
    pkg = Path(_write_package(root, shape, seed, "lin16", sent_norm, system,
                              False))
    (pkg / "tmp").mkdir(exist_ok=True)
    cfg = (pkg / "config").read_text().replace("type=phndec", "type=stkint")
    if input_xform:
        phn_list_to_hmm_defs(str(pkg / "phonemes"), str(pkg / "models"),
                             N_STATES)
        with open(pkg / "models", "a") as f:
            f.write(_input_xform_mmf(SHAPES[shape]["n_phonemes"]
                                     * N_STATES))
        extra = extra.replace("gen_from_phn_list=true",
                              "gen_from_phn_list=false").replace(
            "hmm_defs=$T/models", "hmm_defs=$C/models")
    (pkg / "config").write_text(cfg + extra)
    return pkg


def write_kws_package(root, shape: str = "tiny", seed: int = 0,
                      n_keywords=None, input_xform: bool = False,
                      sent_norm=None) -> str:
    """Write a synthetic stkint KWS package under ``root`` (the LCRC
    package of ``shape`` plus the KWS config lines, keyword list and
    lexicon); returns its path.  ``n_keywords`` replaces the shape's
    keywords by that many generated ones (``_keywords``: 300 at the EN
    shapes make a network past 1,024 models + states); ``input_xform``
    gives the HMM set a global <InputXform> (``_input_xform_mmf``);
    ``sent_norm`` as for write_lcrc_package."""
    pkg = _stkint_package(root, shape, seed, KWS_CONFIG, sent_norm,
                          input_xform)
    words = _keywords(shape, n_keywords, seed)
    (pkg / "kwlist").write_text("".join(f"{w}\n" for w in words))
    (pkg / "kwlex").write_text("".join(f"{w}\t{p}\n"
                                       for w, p in words.items()))
    return str(pkg)


def write_stk_decode_package(root, shape: str = "tiny", seed: int = 0,
                             input_xform: bool = False, sent_norm=None,
                             system: str = "LCRC") -> str:
    """Write a synthetic stkint decode package under ``root`` (the
    ``system`` package of ``shape`` decoded by the STK network decoder
    over the generated phoneme loop); returns its path.  ``input_xform``
    and ``sent_norm`` as for write_kws_package."""
    return str(_stkint_package(root, shape, seed, STK_DECODE_CONFIG,
                               sent_norm, input_xform, system))


def dense_kws_net(M: int, S_M: int, S: int, seed: int = 0):
    """A uniform left-to-right network of M models x S_M states and S
    sinks with random weights, as a DenseKWSScan (the structure kernel B
    takes): in-model, exit, closure and sink weights multiples of -1/8 in
    (-2, 0], closure and sink edges each live with probability 1/2, a word
    reset on a quarter of the live closure edges, model 0 the only
    entry at the start."""
    from phnrec_tpu_torch.decoder.stknet import NEG, DenseKWSScan
    rng = np.random.default_rng(seed)
    E = M * S_M

    def w(*shape):
        return (-rng.integers(0, 16, shape) / 8).astype(np.float32)

    e = np.arange(E)
    A_in = np.full((M + E, E), NEG, np.float32)
    A_in[M + e, e] = w(E)
    adv, first = e[e % S_M != 0], e[e % S_M == 0]
    A_in[M + adv - 1, adv] = w(len(adv))
    A_in[first // S_M, first] = w(len(first))
    A_ex = np.full((E, M), NEG, np.float32)
    A_ex[np.arange(M) * S_M + S_M - 1, np.arange(M)] = w(M)
    live = rng.random((M, M)) < 0.5
    A_cm = np.where(live, w(M, M), NEG).astype(np.float32)
    R_cm = live & (rng.random((M, M)) < 0.25)
    A_cs = np.where(rng.random((M, S)) < 0.5, w(M, S), NEG).astype(
        np.float32)
    entry0 = np.full(M, NEG, np.float32)
    entry0[0] = 0.0
    return DenseKWSScan.from_tables(A_in, A_ex, A_cm, R_cm, A_cs, entry0, S)


def random_network(M: int, n_sinks: int = 3, n_obs: int = 12,
                   seed: int = 0):
    """A random compiled word network (the port's ``CompiledNetwork``) of M
    left-to-right models of 1-3 states, for the edge-list scan: weights
    multiples of -1/8 in (-2, 0] (tie-heavy), an entry skip into state 1
    and an exit from the second-to-last state on some models, closure
    edges between random model pairs (each with probability min(0.3,
    8 / M); a third carry a word and reset the word time), START into
    models 0-2, sink 0 the terminal.  Isolated
    destinations: the last state of model 1 has no incoming edge, the
    last model no closure edge into it, the last sink no sink edge."""
    from phnrec_tpu_torch.decoder.stknet import ClosureEdge, CompiledNetwork
    rng = np.random.default_rng(seed)

    def w():
        return float(-rng.integers(0, 16) / 8)

    obs_index, state_model = [], []
    in_src, in_entry, in_dst, in_w = [], [], [], []
    ex_src, ex_dst, ex_w = [], [], []
    for mi in range(M):
        n = max(int(rng.integers(1, 4)), 2 if mi == 1 else 1)
        base = len(obs_index)
        obs_index += [int(x) for x in rng.integers(0, n_obs, n)]
        state_model += [mi] * n
        for j in range(n):
            if mi == 1 and n > 1 and j == n - 1:
                continue                      # an isolated state
            if j == 0 or (j == 1 and rng.random() < 0.3):
                in_src.append(mi), in_entry.append(True)
                in_dst.append(base + j), in_w.append(w())
            for i in (j - 1, j):
                if i >= 0:
                    in_src.append(base + i), in_entry.append(False)
                    in_dst.append(base + j), in_w.append(w())
        for i in range(n):
            if i == n - 1 or (i == n - 2 and rng.random() < 0.3):
                ex_src.append(base + i), ex_dst.append(mi), ex_w.append(w())
    p = min(0.3, 8 / M)
    closure = [ClosureEdge(-1, d, None, -d / 8, (), False)
               for d in range(min(3, M - 1))]
    for src in range(M):
        for dst in range(M - 1):
            if rng.random() < p:
                words = (f"w{dst}",) if rng.random() < 1 / 3 else ()
                closure.append(ClosureEdge(src, dst, None, w(), words,
                                           bool(words)))
        for s in range(n_sinks - (1 if n_sinks >= 3 else 0)):
            if rng.random() < p or (s == 0 and src == M - 2):
                words = (f"s{s}",) if s else ()
                closure.append(ClosureEdge(src, -1, s, w(), words,
                                           bool(words)))
    E = len(obs_index)
    return CompiledNetwork(
        n_states=E, n_models=M, obs_index=np.asarray(obs_index, np.int32),
        gmm_index=np.full(E, -1, np.int32),
        state_model=np.asarray(state_model, np.int32),
        model_names=[f"m{i}" for i in range(M)],
        in_src=np.asarray(in_src, np.int32),
        in_src_is_entry=np.asarray(in_entry, bool),
        in_dst=np.asarray(in_dst, np.int32),
        in_w=np.asarray(in_w, np.float32),
        ex_src=np.asarray(ex_src, np.int32),
        ex_dst_model=np.asarray(ex_dst, np.int32),
        ex_w=np.asarray(ex_w, np.float32), closure=closure,
        sink_names=[None] + [f"s{s}" for s in range(1, n_sinks)],
        terminal_sink=0, kws_word_sinks=list(range(1, n_sinks)),
        kws_filler_sink=None, gmm_states=[])


def repeated_rows_network(M: int = 16, n_sinks: int = 3, seed: int = 0):
    """``random_network``'s models and sinks with closure edges from four
    row templates of (source model, weight): destinations that share a
    template share the closure row's sequence of sources and weights,
    with edge ids interleaved between them (their rows differ only in
    the ids and in which edges reset the word time); two templates hold
    the same edges with the START edge at another slot; one holds two
    edges from one source at equal and at different weights.  The sinks
    take the templates without START edges; the last model has no
    closure edge into it.  M >= 14."""
    import dataclasses

    from phnrec_tpu_torch.decoder.stknet import ClosureEdge
    rng = np.random.default_rng(seed)
    templates = [[(-1, 0.0), (0, -0.5), (1, -0.25), (2, -0.5)],
                 [(0, -0.5), (-1, 0.0), (1, -0.25), (2, -0.5)],
                 [(3, -0.125), (3, -0.125), (4, -0.75), (4, -0.25),
                  (5, -1.0)],
                 [(m, -0.375) for m in range(6, 14)]]
    dsts = [(d, None, templates[d % 4]) for d in range(M - 1)] + \
        [(-1, s, templates[2 + s % 2]) for s in range(n_sinks)]
    closure = []
    for j in range(max(len(t) for t in templates)):
        for k in rng.permutation(len(dsts)):
            dst, sink, row = dsts[k]
            if j >= len(row):
                continue
            src, w = row[j]
            if src < 0:
                closure.append(ClosureEdge(-1, dst, None, -(dst % 3) / 8,
                                           (), False))
                continue
            if sink is None:
                words = (f"w{dst}",) if rng.random() < 1 / 3 else ()
            else:
                words = (f"s{sink}",) if sink else ()
            closure.append(ClosureEdge(src, dst, sink, w, words,
                                       bool(words)))
    return dataclasses.replace(random_network(M, n_sinks, seed=seed),
                               closure=closure)
