"""ops/trainfb.py: the cluster plan of kernels K and K' (a pure function of
the bucket and of the card's clusters at once, passed in here as a
table) and the plain versions of K and K' held to phnrec_tpu/train/fb.py
at a bucket's width.

The graphs are netgen's PDFObsVec set over 46 phonemes compiled by the
port (tests/test_torch_train.py holds its graphs equal to phnrec_tpu's)
and padded to S 256, 250 or 138, so their LOG_0 pad states are in every
lse; n_frames is ragged.  Tolerances as tests/test_torch_train.py's:
K within rtol 1e-6 / atol 1e-5 (float32 lses summed in another order), K'
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phnrec_tpu.train import fb as jfb

from phnrec_tpu_torch.devtools import trainfb_variants as tv
from phnrec_tpu_torch.ops import trainfb

# clusters of each size an H100 (132 SMs in GPCs of 16-18) holds at once
# at one block an SM, as cudaOccupancyMaxActiveClusters gave them (NVIDIA
# H100 80GB HBM3, 700 W): 16 clusters of 8 do not fit, 17 of 6 do
H100 = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 16: 7}


def only(*sizes):
    """H100 with 0 for the sizes whose slice does not fit in a block, as
    trainfb_cluster_max_active gives it at wider graphs."""
    return {c: n if c in sizes else 0 for c, n in H100.items()}


@pytest.mark.parametrize("B, table, want", [
    (16, H100, 6),           # a training bucket (S 224-256): 96 blocks
    (1, H100, 16),           # sMBR's one utterance (S 256, or 138)
    (7, H100, 16),           # the most clusters of 16 at once
    (8, H100, 8),            # one wave of 8, not two of 16
    (15, H100, 8),
    (17, H100, 6),           # the most of 6 in one wave
    (18, H100, 5),
    (22, H100, 5),
    (23, H100, 4),
    (30, H100, 4),
    (31, H100, 3),
    (32, H100, 3),           # one wave of clusters of 3
    (40, H100, 2),
    (66, H100, 2),
    (67, H100, 3),           # two waves of 3 or of 2: the larger
    (128, H100, 2),          # no size in one wave: the fewest waves
    (16, only(3, 4, 5, 6, 7, 8, 16), 6),     # S 288: no c 2
    (16, only(8, 16), 8),    # S 640 and 672: c 8 in two waves
    (1, only(16), 16),       # S 704 to 928: c 16 only
    (16, only(16), 16),
    (1, only(), 0),          # S 960 and past: the one-block kernels
    (16, only(), 0),
    (1, {**H100, 16: 0}, 8),          # no cluster of 16 placeable
    (16, {**H100, 6: 15}, 5),         # one GPC short
    (4, {}, 0),                       # no cluster at all
])
def test_cluster_plan(B, table, want):
    assert trainfb.cluster_plan(B, table) == want


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return tv.hmm_set(str(tmp_path_factory.mktemp("hmms")),
                      [f"ph{i:02d}" for i in range(46)])


@pytest.mark.parametrize("S, n_phn, ns, ties", [
    (256, 78, (24, 17, 1, 9), False),    # the CZ bucket, ragged n
    (256, 80, (20, 20), True),           # tie-heavy observations
    (250, 81, (13, 24, 5), False),       # no multiple of a cluster size
    (138, 45, (24,), True),              # sMBR's denominator width
])
def test_plain_scans_match_jax_at_bucket_width(models, S, n_phn, ns, ties):
    """graph_fb_plain and graph_align_plain over a padded, ragged bucket
    against phnrec_tpu's forward_backward and viterbi_align utterance by
    utterance: every alpha, beta and likelihood (the pad states' finite
    values near LOG_0 too) within tolerance, states and Viterbi scores
    exact."""
    rng = np.random.default_rng(S + len(ns))
    names = list(models.hmms)
    B, T = len(ns), 24
    trans = [list(rng.choice(names, n_phn - i % 3)) for i in range(B)]
    log_A, entry, exit_ = tv.graph_batch(models, trans, S, "cpu")
    log_b = tv.logpost(rng, B, T, S, "cpu", ties)
    n = torch.tensor(ns, dtype=torch.int32)
    alpha, beta, like = trainfb.graph_fb(log_A, entry, exit_, log_b, n)
    states, vlike = trainfb.graph_align(log_A, entry, exit_, log_b, n)
    for b in range(B):
        args = [jnp.asarray(a[b].numpy()) for a in (log_A, entry, exit_,
                                                     log_b)]
        jr = jfb.forward_backward(*args, ns[b])
        for got, want in ((alpha[b], jr.log_alpha), (beta[b], jr.log_beta),
                          (like[b], jr.log_like)):
            got = got.numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-5)
        ja = jfb.viterbi_align(*args, ns[b])
        np.testing.assert_array_equal(states[b].numpy(),
                                      np.asarray(ja.states))
        assert float(vlike[b]) == float(ja.log_like)
    assert trainfb.LAUNCHES == trainfb.CLUSTER_LAUNCHES == 0
    assert trainfb.ALIGN_LAUNCHES == trainfb.ALIGN_CLUSTER_LAUNCHES == 0
