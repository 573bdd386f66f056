"""End-to-end GMM-HMM training: MMF in, EM iterations, MMF out.

Twin of examples/train_gmm_hmm.py on the port:

  1. parse an HTK MMF (here: a freshly written 2-model toy set),
  2. run EM with the bucketed Reestimator: utterance batches accumulate
     through kernel K (the training graph's forward-backward) on the card,
  3. ML-update means/variances/weights/transitions, write the MMF back
     (trained.mmf in the working directory).

    python -m phnrec_tpu_torch.examples.train_gmm_hmm [--device DEV] [n_iters]
"""

import os
import sys
import tempfile

import numpy as np

from phnrec_tpu_torch.examples import split_device
from phnrec_tpu_torch.io.mmf import parse_mmf, write_mmf
from phnrec_tpu_torch.train import apply_update, update_ml
from phnrec_tpu_torch.train.loop import Reestimator

TOY_MMF = """~o <VecSize> 2 <DIAGC>
~h "hi"
<BeginHMM>
<NumStates> 4
<State> 2 <Mean> 2 0.2 0.2 <Variance> 2 2.0 2.0
<State> 3 <Mean> 2 0.8 0.8 <Variance> 2 2.0 2.0
<TransP> 4
0.0 1.0 0.0 0.0
0.0 0.5 0.5 0.0
0.0 0.0 0.5 0.5
0.0 0.0 0.0 0.0
<EndHMM>
~h "lo"
<BeginHMM>
<NumStates> 3
<State> 2 <Mean> 2 -0.5 -0.5 <Variance> 2 2.0 2.0
<TransP> 3
0.0 1.0 0.0
0.0 0.5 0.5
0.0 0.0 0.0
<EndHMM>
"""


def synth(rng, n):
    """Utterances that really follow hi(2 states) -> lo."""
    out = []
    for _ in range(n):
        a = rng.normal(0.0, 0.7, size=(rng.integers(3, 6), 2)) + 1.0
        b = rng.normal(0.0, 0.7, size=(rng.integers(3, 6), 2)) + 2.5
        c = rng.normal(0.0, 0.7, size=(rng.integers(4, 8), 2)) - 2.0
        out.append(np.concatenate([a, b, c]).astype(np.float32))
    return out


def main(argv=None) -> int:
    device, args = split_device(argv)
    n_iters = int(args[0]) if args else 5

    with tempfile.TemporaryDirectory() as d:
        p0 = os.path.join(d, "init.mmf")
        with open(p0, "w") as f:
            f.write(TOY_MMF)
        models = parse_mmf(p0)

    rng = np.random.default_rng(0)
    data = synth(rng, 24)

    for it in range(n_iters):
        re = Reestimator(models, mode="baum_welch", batch_size=8,
                         device=device)
        for x in data:
            re.add_utterance(x, ["hi", "lo"])
        acc = re.finish()
        upd = update_ml(
            re.index, acc,
            [models.hmms[n].log_transp for n in re.index.names])
        models = apply_update(models, re.index, upd)
        print(f"iter {it}: total log-like {re.total_log_like:10.2f}  "
              f"frames {float(acc.n_frames):.0f}")

    out = "trained.mmf"
    write_mmf(models, out)
    hi = models.hmms["hi"].gmm_states
    print(f"\nwrote {out}")
    print("hi state means:", hi[0].means.ravel(), hi[1].means.ravel())
    print("lo state mean :",
          models.hmms["lo"].gmm_states[0].means.ravel())
    return 0


if __name__ == "__main__":
    sys.exit(main())
