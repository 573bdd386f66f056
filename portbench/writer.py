"""Model packages and audio made from a seed, on the device, without the
program: what a run feeds the system under test and its reference.

Adapted copy, taken 2026-10-18, of phnrec_tpu_torch/synth.py
(``_write_package``, ``_net``, ``save_nbin``'s format, ``synth_audio``):
the same package layout and weight scales, with the weights drawn on the
device by a ``torch.Generator`` in a few large calls, the nets' input
norms measured through the benchmark's own reference frontend instead of
the program's, and the audio made on the device for all segments at
once.  Later changes to synth.py do not reach the benchmark.
"""

from __future__ import annotations

import math
import os
import struct
from pathlib import Path

import numpy as np
import torch

CONFIG = """\
[source]
format=lin16
sample_freq={sample_freq}
[melbanks]
nbanks={nbanks}
lower_freq={lower_freq}
higher_freq={higher_freq}
vector_size={vector_size}
vector_step={vector_step}
[offlinenorm]
sent_mean_norm={sent_mean_norm}
[posteriors]
enabled=true
system=LCRC
length={trap_len}
hamming=true
add_c0=true
softening_func=none 0 0 0
[decoder]
type=phndec
num_states_per_phn={n_states}
wpenalty={wpenalty}
softening_func=log 0 0 0
[dicts]
phoneme_list=$C/phonemes
"""


def seed64(seed: int) -> int:
    """A generator seed for any whole number (negative ones too)."""
    return seed & (2 ** 63 - 1)


def speech_like(gen: torch.Generator, n: int, fs: int, device
                ) -> torch.Tensor:
    """[n] int16 speech-like audio: 40-200 ms segments, each three random
    tones and noise at a random level (synth_audio's recipe)."""
    k = n // (fs // 25) + 1                     # enough segments
    seg = torch.randint(fs // 25, fs // 5, (k,), generator=gen,
                        device=device)
    ends = torch.cumsum(seg, 0)
    k = int(torch.searchsorted(ends, n)) + 1
    seg = seg[:k]
    starts = ends[:k] - seg
    u = torch.rand((len(seg), 12), generator=gen, device=device)
    noise_sd = 0.05 + 0.45 * u[:, 0]
    freq = 100.0 + 3500.0 * u[:, 1:4]
    amp = u[:, 4:7]
    phase = 2 * math.pi * u[:, 7:10]
    level = 200.0 + 5800.0 * u[:, 10]
    sid = torch.repeat_interleave(torch.arange(k, device=device), seg)[:n]
    t = (torch.arange(n, device=device) - starts[sid]).float() / fs
    x = torch.randn(n, generator=gen, device=device) * noise_sd[sid]
    for j in range(3):
        x += amp[sid, j] * torch.sin(2 * math.pi * freq[sid, j] * t
                                     + phase[sid, j])
    return (x * level[sid]).clamp(-32768, 32767).to(torch.int16)


def _net(gen, n_inp: int, n_hid: int, n_out: int, device) -> dict:
    w1 = torch.randn((n_hid, n_inp), generator=gen, device=device) * \
        (4.0 / math.sqrt(n_inp))
    w2 = torch.randn((n_out, n_hid), generator=gen, device=device) * \
        (8.0 / math.sqrt(n_hid))
    return dict(w1=w1, b1=torch.randn(n_hid, generator=gen, device=device)
                * 0.5, w2=w2, b2=-0.5 * w2.sum(1),
                mean=torch.zeros(n_inp, device=device),
                dev=torch.ones(n_inp, device=device))


def save_nbin(path: str, net: dict) -> None:
    """The .nbin layout: int32 2, n_inp, n_hid, n_out, then float32 W1
    [hid16][inp16], W2 [out16][hid16], b1, b2, mean, dev, each dimension
    padded with zeros to a multiple of 4."""
    a = {k: v.detach().cpu().numpy().astype("<f4") for k, v in net.items()}
    nh, ni = a["w1"].shape
    no = a["w2"].shape[0]
    i16, h16, o16 = ((n + 3) & ~3 for n in (ni, nh, no))

    def pad(x, *shape):
        out = np.zeros(shape, "<f4")
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out.tobytes()

    with open(path, "wb") as f:
        f.write(struct.pack("<4i", 2, ni, nh, no))
        f.write(pad(a["w1"], h16, i16) + pad(a["w2"], o16, h16)
                + pad(a["b1"], h16) + pad(a["b2"], o16)
                + pad(a["mean"], i16) + pad(a["dev"], i16))


def write_package(root, cfg: dict, gen: torch.Generator, device,
                  settings: dict = None) -> str:
    """An LCRC phoneme-loop package of the configuration's sizes under
    ``root``; returns its path.  Config, phoneme list (``n_phonemes``;
    the nets have ``n_classes`` classes, the loop's first), Hamming
    half-windows, and three nets of random weights drawn from the
    configuration's ``weights_seed``, their input norms measured on four
    3 s utterances of that seed through the reference frontend; then
    ``gen`` (the run's seed) draws an order of each net's hidden units and
    of the phonemes.  Every seed so computes the same posteriors but for
    the phonemes' names and the order of sums, and the decoders do the
    same work: a seed changes the bits, not the amount of work.
    ``settings`` ({section: {key: value}}) adds a deployment's settings
    to the package's config, as a mix states them."""
    from portbench.references.lcrc_phnloop import Reference
    from portbench.work import net_shapes
    root = Path(root)
    (root / "weights").mkdir(parents=True, exist_ok=True)
    (root / "windows").mkdir(exist_ok=True)
    (root / "config").write_text(CONFIG.format(**dict(
        cfg, sent_mean_norm=str(cfg["sent_mean_norm"]).lower())) + "".join(
        f"[{sec}]\n" + "".join(f"{k}={v}\n" for k, v in kv.items())
        for sec, kv in (settings or {}).items()))
    P, S, C = cfg["n_phonemes"], cfg["n_states"], cfg["n_classes"]
    (root / "phonemes").write_text("".join(f"ph{i:02d}\n"
                                           for i in range(P)))
    L = cfg["trap_len"]
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(L) / (L - 1))
    half = (L - 1) // 2
    for i, win in enumerate((ham[: half + 1], ham[half:])):
        (root / "windows" / f"band{i}.window").write_text(
            " ".join(f"{v:.8f}" for v in win) + "\n")
    base = torch.Generator(device=device)
    base.manual_seed(cfg["weights_seed"])
    nets = [_net(base, *shape, device) for shape in net_shapes(cfg)]
    names = ("band0", "band1", "merger")
    for name, net in zip(names, nets):
        save_nbin(str(root / "weights" / f"{name}.nbin"), net)

    # input norms: the band nets' on the LCRC features of the seeded
    # audio, then the merger's on the band nets' ln outputs
    fs = cfg["sample_freq"]
    ref = Reference(cfg, str(root), device)
    feats = [[], []]
    for _ in range(4):
        w = speech_like(base, 3 * fs, fs, device).cpu().numpy()
        par = ref.features(w, cfg["sent_mean_norm"])
        nb = par.shape[1]
        p3 = torch.cat([par[:1].expand(half, nb), par,
                        par[-1:].expand(half, nb)]).float()
        win = p3.unfold(0, 2 * half + 1, 1)
        for i, j in ((0, 0), (1, half)):
            feats[i].append((win[:, :, j: j + half + 1]
                             @ ref.taps[i].float()).reshape(win.shape[0],
                                                            -1))
    outs = []
    for i in range(2):
        x = torch.cat(feats[i])
        nets[i]["mean"] = x.mean(0)
        nets[i]["dev"] = 1.0 / x.std(0, unbiased=False).clamp(min=1e-3)
        xn = (x - nets[i]["mean"]) * nets[i]["dev"]
        h = torch.sigmoid(xn @ nets[i]["w1"].T + nets[i]["b1"])
        outs.append(torch.log_softmax(h @ nets[i]["w2"].T + nets[i]["b2"],
                                      -1))
    m = torch.cat(outs, -1)
    nets[2]["mean"] = m.mean(0)
    nets[2]["dev"] = 1.0 / m.std(0, unbiased=False).clamp(min=1e-3)

    # the seed's order: output class j of every net is class cls[j] of
    # the drawn nets (phoneme phn[j // S], its states in order), and the
    # merger reads its inputs in that order too
    # and the classes past the loop's (the oth class) stay last
    phn = torch.randperm(P, generator=gen, device=device)
    cls = torch.cat([(phn[:, None] * S + torch.arange(S, device=device))
                     .reshape(-1), torch.arange(P * S, C * S, device=device)])
    for net in nets:
        h = torch.randperm(net["w1"].shape[0], generator=gen, device=device)
        net["w1"], net["b1"] = net["w1"][h], net["b1"][h]
        net["w2"], net["b2"] = net["w2"][cls][:, h], net["b2"][cls]
    inp = torch.cat([cls, cls + C * S])
    for k in ("mean", "dev"):
        nets[2][k] = nets[2][k][inp]
    nets[2]["w1"] = nets[2]["w1"][:, inp]
    for name, net in zip(names, nets):
        save_nbin(str(root / "weights" / f"{name}.nbin"), net)
    return str(root)


def write_corpus(directory, waves, names) -> str:
    """One raw lin16 file per utterance and a two-column list (source,
    MLF name); returns the list's path."""
    os.makedirs(directory, exist_ok=True)
    lines = []
    for w, name in zip(waves, names):
        p = os.path.join(directory, f"{name}.raw")
        with open(p, "wb") as f:
            f.write(w.astype("<i2").tobytes())
        lines.append(f"{p} {name}\n")
    list_path = os.path.join(directory, "list")
    with open(list_path, "w") as f:
        f.writelines(lines)
    return list_path
