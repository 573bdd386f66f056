"""The port's twins of the JAX package's ``examples/`` scripts.

Each twin takes its original's positional arguments, prints its lines in
the same format, and adds one option, ``--device`` (default ``cuda``; the
CPU runs the kernels' plain versions):

    python -m phnrec_tpu_torch.examples.batch_decode PKG OUT_DIR a.raw ...
    python -m phnrec_tpu_torch.examples.streaming_decode PKG a.raw [chunk_ms]
    python -m phnrec_tpu_torch.examples.keyword_spotting PKG a.raw "kw=p h n"
    python -m phnrec_tpu_torch.examples.multistream_serving [--mesh] PKG a.raw ...
    python -m phnrec_tpu_torch.examples.train_gmm_hmm [n_iters]

Each has ``main(argv=None) -> int``, ``argv`` being the arguments after
the program's name (``sys.argv[1:]`` when None).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple


def split_device(argv: Optional[Sequence[str]]) -> Tuple[str, List[str]]:
    """(the device, the other arguments) of a twin's command line:
    ``--device DEV`` anywhere, ``cuda`` without."""
    args = list(sys.argv[1:] if argv is None else argv)
    for i, a in enumerate(args):
        if a == "--device" and i + 1 < len(args):
            return args[i + 1], args[:i] + args[i + 2:]
    return "cuda", args
