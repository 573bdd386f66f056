"""The correctness check catches a broken timed path: each fault a cell
can have is planted in the program underneath a whole run (the harness's
look for a chip skipped, the CPU at a tiny size), and ``correct`` comes
out false; the control (the reference one precision down in the
program's place) fails the committed limits too, on the smallest cells
where it shows what it shows at the committed cells' sizes."""

import pytest
import torch

from tinycells import CONTROL_MIXES, tiny_root
from portbench import run as R
from portbench.control import control_readings
from phnrec_tpu_torch.decoder import phnloop
from phnrec_tpu_torch.io.labels import Label
from phnrec_tpu_torch.multistream import MultiStreamRecognizer

SEED = 2 ** 35 + 3


def _altered(labels_from_segments):
    """A label's phoneme altered where the labels are made."""
    def fn(*a, **kw):
        out = labels_from_segments(*a, **kw)
        for labs in out:
            if labs:
                l0 = labs[0]
                other = "ph01" if l0.name != "ph01" else "ph02"
                labs[0] = Label(l0.start_frames, l0.end_frames, other,
                                l0.score)
        return out
    return fn


def _score_altered(labels_from_segments):
    """A label's score moved by half a nat where the labels are made."""
    def fn(*a, **kw):
        out = labels_from_segments(*a, **kw)
        for labs in out:
            if labs:
                l0 = labs[0]
                labs[0] = Label(l0.start_frames, l0.end_frames, l0.name,
                                l0.score + 0.5)
        return out
    return fn


def _half_left_out(labels_from_segments):
    """Every second row of a batch gets no labels."""
    def fn(*a, **kw):
        out = labels_from_segments(*a, **kw)
        return [[] if i % 2 else labs for i, labs in enumerate(out)]
    return fn


def _state_unchanged(decode_block):
    """A step that hands its carry back unchanged."""
    def fn(self, carry, lp, n_dec, n_valid):
        _, hist = decode_block(self, carry, lp, n_dec, n_valid)
        return carry, hist
    return fn


FAULTS = [
    ("tiny_archive", "answer_altered"),
    ("tiny_archive", "score_altered"),
    ("tiny_archive", "half_left_out"),
    ("tiny_live", "answer_altered"),
    ("tiny_live", "score_altered"),
    ("tiny_live", "state_unchanged"),
]
WRAPS = {"answer_altered": _altered, "score_altered": _score_altered,
         "half_left_out": _half_left_out}


@pytest.mark.parametrize("mix,fault", FAULTS)
def test_a_planted_fault_makes_correct_false(tmp_path, monkeypatch, mix,
                                             fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(MultiStreamRecognizer, "_decode_block",
                            _state_unchanged(
                                MultiStreamRecognizer._decode_block))
    else:
        monkeypatch.setattr(phnloop, "labels_from_segments",
                            WRAPS[fault](phnloop.labels_from_segments))
    res = R.run_cell(tiny_root(tmp_path), f"cz_lcrc_n1500.{mix}", SEED,
                     0.5, False, torch.device("cpu"))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("mix", sorted(CONTROL_MIXES))
def test_the_control_fails(tmp_path, mix):
    out = control_readings(tiny_root(tmp_path), f"cz_lcrc_n1500.{mix}",
                           SEED, torch.device("cpu"))
    assert out["correct"] is False, out["checks"]
