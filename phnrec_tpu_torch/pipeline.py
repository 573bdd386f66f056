"""Pipeline orchestration: SpeechRec on one torch device.

Counterpart of phnrec_tpu/pipeline.py.  Reference: srec.{cpp,h} — the
integration class that owns config, frontend, posterior estimator and
decoder, and routes data between pipeline stages (srec.cpp:929-1111):

    wf ----> par ----> post ----> str
    raw      HTK       HTK        .rec / MLF
    audio    features  posteriors

The port covers both frontends (mel banks, PLP), the four posterior
systems (LCRC, 3BT, 1BT, 1BT_DCT), ``posteriors/enabled=false`` and both
decoders, the phoneme loop (``phndec``) and the STK network decoder
(``stkint``, decode and KWS modes), at every stage pair.  Waveform-to-
string file lists run batched through BatchPipeline where phnrec_tpu's
``_can_batch_list`` batches them, and a single waveform as a batch of one;
the staged pairs run file by file through ``params_from_waveform``,
``posteriors_from_params`` and ``decode_posteriors`` on the device.  An
stkint package decodes through ``stk_decoder`` (kernels G and H), as
phnrec_tpu/pipeline.py:212-221 and :391-400 do; the multi-stream KWS
server (multistream.py) serves it live.  A phoneme-loop list keeps up to
three batches in flight (``fetch_segments_start`` / ``_finish``).  The
stages wave_convert, mel_frontend, posteriors, viterbi and backtrack are
timed by ``utils.profiling.TIMER`` when it is enabled (the CLI's
``--profile``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from phnrec_tpu_torch import normalization, softening
from phnrec_tpu_torch.config import PhnRecConfig
from phnrec_tpu_torch.decoder.phnloop import PhnLoopSpec
from phnrec_tpu_torch.frontend import melbanks
from phnrec_tpu_torch.io import audio, htk
from phnrec_tpu_torch.io.labels import Label, MLFWriter, format_rec_line
from phnrec_tpu_torch.io.weights import load_phoneme_list
from phnrec_tpu_torch.posteriors.estimator import build_estimator
from phnrec_tpu_torch.utils.filename import (change_file_path,
                                             change_file_suffix)
from phnrec_tpu_torch.utils.profiling import TIMER, span

# process_file_list calls in this process: the list path's request ids
_LIST_CALLS = itertools.count()

# data_format stage ordering (srec.h: dfWaveform < dfParams < dfPosteriors
# < dfStrings)
STAGES = ("wf", "par", "post", "str")
_NO_TRAPS = ("The 'traps' module have to be enabled for generating "
             "posteriors")


def _stage_index(name: str) -> int:
    if name not in STAGES:
        raise ValueError(
            f"Invalid data format {name!r}. Supported data formats are "
            "'wf', 'par', 'post' and 'str'.")
    return STAGES.index(name)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with the index filled in for CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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

        # -- posterior estimator (srec.cpp:603-624); without it the
        # decoder reads its posteriors from files (-s post)
        self.traps_enabled = cfg.get_bool("posteriors", "enabled")
        self.estimator = None
        if self.traps_enabled:
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
    # stage functions, one utterance each on the device.  phnrec_tpu pads
    # T to a 256-frame quantum to bound its compiles; eager PyTorch needs
    # no padding, so each runs at the utterance's own T.
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def params_from_waveform(self, raw: bytes) -> np.ndarray:
        """wf -> par: [T, n_params] features, frame-normalized but NOT
        sentence-normalized (ProcessOffline runs the sentence norm at the
        par -> post boundary, srec.cpp:977-1000)."""
        with TIMER.stage("wave_convert"):
            wave, _ = audio.convert_waveform(
                raw, self.wave_format, scale=self.wave_scale,
                dc_shift=self.wave_dc_shift, noise_level=self.wave_noise)
        T = self.frontend.frame_count(len(wave))
        with TIMER.stage("mel_frontend"):
            par = self.frontend(torch.from_numpy(wave).to(self.device)[None],
                                T)
            par = normalization.frame_norm(par, self.frame_shift,
                                           self.frame_floor)
            return par[0].cpu().numpy()

    @torch.inference_mode()
    def posteriors_from_params(self, par: np.ndarray) -> np.ndarray:
        """par -> post, including the sentence normalization and the
        posteriors-stage softening function."""
        if self.estimator is None:
            raise RuntimeError(_NO_TRAPS)
        n_p = self.frontend.n_params
        if par.shape[1] < n_p:
            raise ValueError("Invalid dimensionality of parameter vectors")
        par = np.array(par[:, :n_p], np.float32)  # truncate, srec.cpp:988
        with TIMER.stage("posteriors"):
            x = torch.from_numpy(par).to(self.device)[None]
            n = torch.full((1,), par.shape[0], dtype=torch.int32,
                           device=self.device)
            sent = normalization.sentence_norm(x, self.sent_norm, n_valid=n)
            post = self.estimator.posteriors(sent[0])
            return self.post_soft(post).cpu().numpy()

    @torch.inference_mode()
    def decode_posteriors(self, post: np.ndarray) -> DecodeResult:
        """post -> str: the decoder softening, then the phoneme-loop scan
        and walk back (kernels C and D) or the STK network decoder."""
        lp = self.dec_soft(torch.tensor(np.asarray(post, np.float32),
                                        device=self.device))
        return self._decode_log_posteriors(lp)

    def _decode_log_posteriors(self, lp: torch.Tensor) -> DecodeResult:
        """One utterance's decoder-ready log-posteriors [T, D] -> labels."""
        from phnrec_tpu_torch.decoder import phnloop
        with TIMER.stage("viterbi", block=self.device):
            if self.stk_decoder is not None:
                return DecodeResult(self.stk_decoder.decode(lp))
            T = lp.shape[0]
            spec = self.loop_spec
            hist = phnloop.viterbi_scan_batch(spec, lp[None])
            # one slot past the T//S + 1 a row can fill (backtrack_device)
            segs = phnloop.backtrack_device(
                spec, hist, torch.tensor([T], device=self.device),
                smax=phnloop.max_segments(spec, T) + 1)
        with TIMER.stage("backtrack"):
            segs = phnloop.fetch_segments(segs)
            return DecodeResult(phnloop.labels_from_segments(
                segs, np.asarray([T]), self.phonemes)[0])

    @torch.inference_mode()
    def _decode_waveform(self, raw: bytes) -> DecodeResult:
        """wf -> str on raw waveform bytes: the batch pipeline's posterior
        stages as a batch of one, then the decoder."""
        with TIMER.stage("wave_convert"):
            wave, _ = audio.convert_waveform(
                raw, self.wave_format, scale=self.wave_scale,
                dc_shift=self.wave_dc_shift, noise_level=self.wave_noise)
        bp = self.batch_pipeline
        w, nf, max_frames, ns = bp.to_device(*bp.pad_batch([wave]))
        return self._decode_log_posteriors(
            bp._post_core(w, nf, max_frames, ns)[0])

    # ------------------------------------------------------------------
    # staged file processing (ProcessFile, srec.cpp:1113-1199)
    # ------------------------------------------------------------------
    def process_offline(self, inpf: str, outpf: str, data):
        """Run stages inpf -> outpf; ``data`` is bytes (wf) or an array
        [T, D] (par, post).  Returns an array (par, post) or a
        DecodeResult (str)."""
        i, o = _stage_index(inpf), _stage_index(outpf)
        if i >= o:
            raise ValueError("output format must be later than input")
        if inpf == "wf":
            if outpf == "str" and self.traps_enabled:
                return self._decode_waveform(data)
            data = self.params_from_waveform(data)
            if outpf == "par":
                return data
        if o >= 2 and i <= 1:
            if not self.traps_enabled and outpf == "post":
                raise RuntimeError(_NO_TRAPS)
            if self.traps_enabled:
                data = self.posteriors_from_params(data)
            if outpf == "post":
                return data
        return self.decode_posteriors(data)

    def process_file(self, inpf: str, outpf: str, source: str,
                     target: Optional[str] = None,
                     mlf: Optional[MLFWriter] = None):
        self.log_fn(f"{source} -> {target}\n" if target else f"{source}\n")
        if inpf == "wf":
            data = audio.load_waveform_bytes(source)
        else:
            data, _, _ = htk.read_htk(source)
        result = self.process_offline(inpf, outpf, data)
        if outpf in ("par", "post"):
            if target is None:
                raise ValueError("par/post output requires a target file")
            htk.write_htk(target, result)
        elif mlf is not None:
            mlf.add(target, result.labels)
        elif target is not None:
            with open(target, "w") as f:
                for line in result.rec_lines():
                    f.write(line + "\n")
        return result

    def compose_target_name(self, source: str, outpf: str,
                            for_mlf: bool) -> str:
        """Target name from a one-column list line (srec.cpp:1216-1236).
        For post targets the reference reads the unregistered
        "traps/suffix" entry (srec.cpp:1224); phnrec_tpu and the port read
        the registered posteriors/suffix."""
        cfg = self.cfg
        if outpf == "par":
            return change_file_suffix(source, cfg.get_str("params", "suffix"))
        if outpf == "post":
            return change_file_suffix(source,
                                      cfg.get_str("posteriors", "suffix"))
        if outpf == "str":
            name = change_file_suffix(source, cfg.get_str("labels", "suffix"))
            if for_mlf and cfg.get_bool("labels", "remove_path"):
                name = change_file_path(name, "*")
            return name
        raise ValueError(outpf)

    def process_file_list(self, inpf: str, outpf: str, list_path: str,
                          mlf_path: Optional[str] = None) -> None:
        """Process every line of a list (``SOURCE [TARGET]``), one MLF
        for the targets with ``mlf_path``.  Span ``list``; its batches'
        request ids are (the call's number, the batch's index)."""
        call = next(_LIST_CALLS)
        with span("list", id=(call, None)):
            entries = []
            with open(list_path) as f:
                for raw in f:
                    parts = raw.split()
                    if not parts:
                        continue
                    source = parts[0]
                    target = (parts[1] if len(parts) > 1 else
                              self.compose_target_name(
                                  source, outpf,
                                  for_mlf=mlf_path is not None))
                    entries.append((source, target))
            if self._can_batch_list(inpf, outpf):
                self._process_file_list_batched(entries, mlf_path, call)
                return
            mlf = MLFWriter(mlf_path) if mlf_path else None
            try:
                for source, target in entries:
                    self.process_file(inpf, outpf, source, target, mlf)
            finally:
                if mlf:
                    mlf.close()

    def _can_batch_list(self, inpf: str, outpf: str) -> bool:
        """phnrec_tpu's rule (phnrec_tpu/pipeline.py:327-338): raw
        waveforms -> strings through the mel frontend and the estimator,
        without dither, run batched; every other list (staged I/O, PLP,
        dithered sources) goes file by file."""
        return (inpf == "wf" and outpf == "str"
                and self.estimator is not None
                and type(self.frontend) is melbanks.MelFrontend
                and self.wave_noise == 0.0)

    def _process_file_list_batched(self, entries, mlf_path: Optional[str],
                                   call: int) -> None:
        """File-list decode through PrefetchLoader buckets + the batch
        pipeline (stkint: its posteriors, then the network decoder over
        the batch); results are written in LIST ORDER, as the reference's
        serial loop writes them (srec.cpp:1246-1291).  Spans
        ``list.loader_wait`` (the wait for the loader's next batch),
        ``list.log``, ``list.launch`` and ``list.finish`` a batch (request
        id (call, batch index)), ``list.mlf`` around the writes."""
        from phnrec_tpu_torch.decoder import phnloop
        from phnrec_tpu_torch.parallel.loader import PrefetchLoader

        bp = self.batch_pipeline
        loader = PrefetchLoader(
            [s for s, _ in entries], fmt=self.wave_format,
            scale=self.wave_scale, dc_shift=self.wave_dc_shift,
            noise_level=self.wave_noise,
            sample_freq=self.cfg.get_int("source", "sample_freq"),
            max_batch=256, granularity=2 * self.cfg.get_int(
                "source", "sample_freq"), prefetch=3, n_workers=8,
            raw_int16=self.wave_format == "lin16",
            raw_alaw=self.wave_format == "alaw")
        results: dict = {}

        def finish(pending) -> None:
            req, indices, fetched, n_frames = pending
            with span("list.finish", id=req):
                labels = phnloop.labels_from_segments(
                    phnloop.fetch_segments_finish(fetched), n_frames,
                    self.phonemes)
                for idx, labs in zip(indices, labels):
                    results[idx] = labs

        # up to three batches in flight, as phnrec_tpu keeps them: batch
        # i's segments copy to pinned host memory behind an event while
        # the card runs batch i+1 and the host builds batch i-1's labels
        inflight: list = []
        batches = iter(loader)
        for k in itertools.count():
            req = (call, k)
            with span("list.loader_wait", id=req):
                batch = next(batches, None)
            if batch is None:
                break
            with span("list.log", id=req):
                self.log_fn("".join(
                    f"{s} -> {t}\n" for s, t in
                    (entries[i] for i in batch.indices)))
            with span("list.launch", id=req):
                w, nf, max_frames, ns = bp.to_device(batch.wave,
                                                     batch.n_samples)
                n_frames = bp.frame_counts(batch.n_samples)
                if self.stk_decoder is not None:
                    labels = self.stk_decoder.decode_batch(
                        bp._post_core(w, nf, max_frames, ns), n_frames)
                    for idx, labs in zip(batch.indices, labels):
                        results[idx] = labs
                    continue
                inflight.append((req, batch.indices,
                                 phnloop.fetch_segments_start(
                                     bp._core(w, nf, max_frames, ns)),
                                 n_frames))
            if len(inflight) > 2:
                finish(inflight.pop(0))
        for pending in inflight:
            finish(pending)

        with span("list.mlf"):
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
