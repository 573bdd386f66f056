"""Pipeline orchestration: SpeechRec on one torch device.

Counterpart of phnrec_tpu/pipeline.py:58-133,237-422.  Reference:
srec.{cpp,h} — the integration class that owns config, frontend, posterior
estimator and decoder.  The port covers both frontends (mel banks, PLP),
the four posterior systems (LCRC, 3BT, 1BT, 1BT_DCT) and both decoders,
the phoneme loop (``phndec``) and the STK network decoder (``stkint``,
decode and KWS modes), for waveform input and string output (wf -> str):
file lists run batched through
BatchPipeline, and single files run as a batch of one.  An stkint package
decodes its batches' posteriors through ``stk_decoder.decode_batch``
(kernels G and H), as phnrec_tpu/pipeline.py:212-221 and :391-400 do;
the multi-stream KWS server (multistream.py) serves it live.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from phnrec_tpu_torch import normalization, softening
from phnrec_tpu_torch.config import PhnRecConfig
from phnrec_tpu_torch.decoder.phnloop import PhnLoopSpec
from phnrec_tpu_torch.frontend import melbanks
from phnrec_tpu_torch.io import audio
from phnrec_tpu_torch.io.labels import Label, MLFWriter, format_rec_line
from phnrec_tpu_torch.io.weights import load_phoneme_list
from phnrec_tpu_torch.posteriors.estimator import build_estimator
from phnrec_tpu_torch.utils.filename import (change_file_path,
                                             change_file_suffix)



def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with the index filled in for CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _require_wf_str(inpf: str, outpf: str) -> None:
    """The port decodes waveforms to strings; the reference's other stage
    pairs (srec.cpp:929-1111) are not ported yet."""
    if (inpf, outpf) != ("wf", "str"):
        raise NotImplementedError(
            f"{inpf} -> {outpf}: staged par/post input or output is not "
            "ported yet (ROADMAP.md, Queue 1 item 19: serial par/post "
            "staged I/O)")


@dataclass
class DecodeResult:
    labels: List[Label]

    def rec_lines(self, mlf_style: bool = False) -> List[str]:
        return [format_rec_line(l, mlf_style) for l in self.labels]


class SpeechRec:
    """Loads a model package onto ``device`` and decodes files or lists."""

    def __init__(self, config_dir: str, fast_exp: bool = True,
                 log_fn=None, device="cuda"):
        # float32 throughout: cuDNN runs float32 convolutions in TF32 by
        # default, which would break parity of the LCRC convs with
        # phnrec_tpu; matmuls are float32 by default, set here explicitly.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = resolve_device(device)
        self.config_dir = config_dir
        self.cfg = cfg = PhnRecConfig.load_package(config_dir)
        self.log_fn = log_fn or (lambda msg: None)

        # -- frontend (srec.cpp:545-590)
        kind = cfg.get_str("params", "kind")
        if kind == "plp":
            from phnrec_tpu_torch.frontend.plp import PLPFrontend
            self.frontend = PLPFrontend(melbanks.spec_from_config(cfg),
                                        cfg).to(self.device)
        elif kind == "fbanks":
            self.frontend = melbanks.MelFrontend(
                melbanks.spec_from_config(cfg)).to(self.device)
        else:
            raise ValueError(f"unknown params/kind {kind!r}")
        self.wave_format = cfg.get_str("source", "format")
        if self.wave_format not in ("lin16", "alaw"):
            raise ValueError(
                f"Invalid waveform format {self.wave_format!r}. Supported "
                "data formats are 'lin16' and 'alaw'.")
        self.wave_scale = cfg.get_float("source", "scale")
        self.wave_dc_shift = cfg.get_float("source", "dc_shift")
        self.wave_noise = cfg.get_float("source", "noise_level")

        # -- normalization
        self.frame_shift = cfg.get_float("framenorm", "shift")
        self.frame_floor = cfg.get_float("framenorm", "min_floor")
        self.sent_norm = normalization.spec_from_config(cfg)

        # -- posterior estimator (srec.cpp:603-624)
        if not cfg.get_bool("posteriors", "enabled"):
            raise NotImplementedError(
                "posteriors/enabled=false needs staged post input, which is "
                "not ported yet (ROADMAP.md, Queue 1 item 19: serial "
                "par/post staged I/O)")
        self.estimator = build_estimator(
            cfg.get_str("posteriors", "system"),
            config_dir,
            nbanks=cfg.get_int("melbanks", "nbanks"),
            trap_len=cfg.get_int("posteriors", "length"),
            add_c0=cfg.get_bool("posteriors", "add_c0"),
            use_hamming=cfg.get_bool("posteriors", "hamming"),
            fast_exp=fast_exp,
        ).to(self.device)

        # -- softening (srec.cpp:667-671)
        self.post_soft = softening.softening_fn(
            softening.parse_softening(
                cfg.get_str("posteriors", "softening_func")))
        self.dec_soft = softening.softening_fn(
            softening.parse_softening(cfg.get_str("decoder",
                                                  "softening_func")))

        # -- decoder (srec.cpp:627-665)
        self.decoder_type = cfg.get_str("decoder", "type")
        self.phonemes = load_phoneme_list(
            cfg.get_str("dicts", "phoneme_list"))
        self.wpenalty = cfg.get_float("decoder", "wpenalty")
        self.loop_spec = PhnLoopSpec(
            n_phonemes=len(self.phonemes),
            n_states=cfg.get_int("decoder", "num_states_per_phn"),
            w_penalty=self.wpenalty,
        )
        self.stk_decoder = None
        if self.decoder_type == "stkint":
            from phnrec_tpu_torch.decoder.stknet import StkNetworkDecoder
            self.stk_decoder = StkNetworkDecoder.from_config(self, cfg)
        self._bp = None

    def set_wpenalty(self, wpenalty: float) -> None:
        """CLI -p override (phnrec.cpp:212-221)."""
        self.wpenalty = wpenalty
        self.loop_spec = self.loop_spec._replace(w_penalty=wpenalty)
        if self.stk_decoder is not None:
            self.stk_decoder.set_wpenalty(wpenalty)

    def _require_phnloop(self) -> None:
        """The phoneme-loop decode (BatchPipeline._core) is not an stkint
        package's decoder: it decodes through ``stk_decoder``."""
        if self.stk_decoder is not None:
            raise ValueError(
                "an stkint package decodes through its STK network decoder "
                "(stk_decoder.decode_batch), not the phoneme loop")

    @property
    def batch_pipeline(self):
        if self._bp is None:
            from phnrec_tpu_torch.parallel.batch import BatchPipeline
            self._bp = BatchPipeline(self)
        return self._bp

    # ------------------------------------------------------------------
    # staged file processing (ProcessFile, srec.cpp:1113-1199)
    # ------------------------------------------------------------------
    def process_offline(self, inpf: str, outpf: str, data) -> DecodeResult:
        """wf -> str on raw waveform bytes, as a batch of one."""
        _require_wf_str(inpf, outpf)
        wave, _ = audio.convert_waveform(
            data, self.wave_format, scale=self.wave_scale,
            dc_shift=self.wave_dc_shift, noise_level=self.wave_noise)
        bp = self.batch_pipeline
        if self.stk_decoder is None:
            return DecodeResult(bp.run([wave]).labels[0])
        w, nf, max_frames, ns = bp.to_device(*bp.pad_batch([wave]))
        lp = bp._post_core(w, nf, max_frames, ns)
        return DecodeResult(self.stk_decoder.decode_batch(
            lp, nf.cpu().numpy())[0])

    def process_file(self, inpf: str, outpf: str, source: str,
                     target: Optional[str] = None,
                     mlf: Optional[MLFWriter] = None) -> DecodeResult:
        self.log_fn(f"{source} -> {target}\n" if target else f"{source}\n")
        _require_wf_str(inpf, outpf)
        result = self.process_offline(inpf, outpf,
                                      audio.load_waveform_bytes(source))
        if mlf is not None:
            mlf.add(target, result.labels)
        elif target is not None:
            with open(target, "w") as f:
                for line in result.rec_lines():
                    f.write(line + "\n")
        return result

    def compose_target_name(self, source: str, outpf: str,
                            for_mlf: bool) -> str:
        """Target name of a label file from a one-column list line
        (srec.cpp:1216-1236)."""
        _require_wf_str("wf", outpf)
        cfg = self.cfg
        name = change_file_suffix(source, cfg.get_str("labels", "suffix"))
        if for_mlf and cfg.get_bool("labels", "remove_path"):
            name = change_file_path(name, "*")
        return name

    def process_file_list(self, inpf: str, outpf: str, list_path: str,
                          mlf_path: Optional[str] = None) -> None:
        _require_wf_str(inpf, outpf)
        entries = []
        with open(list_path) as f:
            for raw in f:
                parts = raw.split()
                if not parts:
                    continue
                source = parts[0]
                target = (parts[1] if len(parts) > 1 else
                          self.compose_target_name(
                              source, outpf, for_mlf=mlf_path is not None))
                entries.append((source, target))
        self._process_file_list_batched(entries, mlf_path)

    def _process_file_list_batched(self, entries,
                                   mlf_path: Optional[str]) -> None:
        """File-list decode through PrefetchLoader buckets + the batch
        pipeline (stkint: its posteriors, then the network decoder over
        the batch); results are written in LIST ORDER, as the reference's
        serial loop writes them (srec.cpp:1246-1291)."""
        from phnrec_tpu_torch.decoder import phnloop
        from phnrec_tpu_torch.parallel.loader import PrefetchLoader

        bp = self.batch_pipeline
        dither = self.wave_noise != 0.0
        loader = PrefetchLoader(
            [s for s, _ in entries], fmt=self.wave_format,
            scale=self.wave_scale, dc_shift=self.wave_dc_shift,
            noise_level=self.wave_noise,
            sample_freq=self.cfg.get_int("source", "sample_freq"),
            max_batch=256, granularity=2 * self.cfg.get_int(
                "source", "sample_freq"), prefetch=3, n_workers=8,
            raw_int16=self.wave_format == "lin16" and not dither,
            raw_alaw=self.wave_format == "alaw" and not dither)
        results: dict = {}
        for batch in loader:
            self.log_fn("".join(
                f"{s} -> {t}\n" for s, t in
                (entries[i] for i in batch.indices)))
            w, nf, max_frames, ns = bp.to_device(batch.wave, batch.n_samples)
            n_frames = bp.frame_counts(batch.n_samples)
            if self.stk_decoder is not None:
                labels = self.stk_decoder.decode_batch(
                    bp._post_core(w, nf, max_frames, ns), n_frames)
            else:
                segs = phnloop.fetch_segments(
                    bp._core(w, nf, max_frames, ns))
                labels = phnloop.labels_from_segments(segs, n_frames,
                                                      self.phonemes)
            for idx, labs in zip(batch.indices, labels):
                results[idx] = labs

        mlf = MLFWriter(mlf_path) if mlf_path else None
        try:
            for idx, (source, target) in enumerate(entries):
                labels = results[idx]
                if mlf is not None:
                    mlf.add(target, labels)
                elif target is not None:
                    with open(target, "w") as f:
                        for line in DecodeResult(labels).rec_lines():
                            f.write(line + "\n")
        finally:
            if mlf:
                mlf.close()

