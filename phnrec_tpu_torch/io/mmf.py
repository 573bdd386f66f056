"""HTK MMF (master model file) parser — the subset STK/phnrec exercises.

Copy of phnrec_tpu/io/mmf.py (host code without JAX, kept in step with it).

Reference: STKLib/Models_IO.cc ParseMmf.  Supported:

  * global options ``~o <VecSize> N <PDFObsVec>`` or ``<DIAGC>`` etc.
  * ``~h "name"`` HMM definitions with <NUMSTATES>, per-state <STATE> n
    followed by either <ObsCoef> k (posterior lookup models, the phnrec
    path — index stored 0-based like Models_IO.cc:827) or a DiagC GMM
    (<NUMMIXES>, <MIXTURE> m w, <MEAN>, <VARIANCE>, optional <GCONST>),
  * <TRANSP> N with an N x N row-major probability matrix (converted to
    log domain like Models_IO's transition reader),
  * shared-macro definitions ~s (state), ~t (transition) and references.

GMM output log-likelihood (diagonal covariance):
  log sum_m w_m * N(x; mu_m, Sigma_m)
  with log N = -0.5 * (gconst + sum_d (x_d - mu_d)^2 / var_d),
  gconst = D*log(2*pi) + sum_d log var_d   (HTK convention).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

LOG_0 = -1e10  # STK LOG_0 stand-in for zero transition probabilities


@dataclass
class GMMState:
    weights: np.ndarray      # [M]
    means: np.ndarray        # [M, D]
    variances: np.ndarray    # [M, D]
    gconsts: np.ndarray      # [M]


@dataclass
class HmmDef:
    name: str
    n_states: int                       # includes entry+exit
    obs_coefs: List[Optional[int]] = field(default_factory=list)
    gmm_states: List[Optional[GMMState]] = field(default_factory=list)
    log_transp: Optional[np.ndarray] = None   # [N, N]


@dataclass
class ModelSet:
    vec_size: int
    pdf_obs_vec: bool
    hmms: Dict[str, HmmDef]
    # feature-transform machinery (Models.h:891-1028): ~x / ~j macros and
    # the global <InputXform>, applied to observations before scoring
    xforms: Optional[Dict] = None
    xform_instances: Optional[Dict] = None
    input_xform: Optional[object] = None


class _Tok:
    def __init__(self, text: str):
        # HTK tokens: quoted strings, <KEYWORDS>, bare atoms
        self.toks = re.findall(r'"[^"]*"|<[^>]+>|\S+', text)
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of MMF")
        self.pos += 1
        return t

    def expect(self, kw: str) -> None:
        t = self.next()
        if t.upper() != kw.upper():
            raise ValueError(f"expected {kw}, got {t}")

    def get_int(self) -> int:
        return int(self.next())

    def get_float(self) -> float:
        return float(self.next())

    def get_floats(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        for i in range(n):
            out[i] = float(self.next())
        return out


def _log_probs(mat: np.ndarray) -> np.ndarray:
    out = np.full(mat.shape, LOG_0, np.float32)
    nz = mat > 0
    out[nz] = np.log(mat[nz])
    return out


def parse_mmf(path: str) -> ModelSet:
    tk = _Tok(open(path, "r", encoding="latin-1").read())
    vec_size = 0
    pdf_obs_vec = False
    hmms: Dict[str, HmmDef] = {}
    shared_states: Dict[str, tuple] = {}
    shared_trans: Dict[str, np.ndarray] = {}

    def parse_state_body():
        """After <STATE> n: -> (obs_coef | None, gmm | None)."""
        t = tk.peek()
        if t and t.startswith("~"):           # ~s "macro" reference
            tk.next()
            name = tk.next().strip('"')
            return shared_states[name]
        if t and t.upper() == "<OBSCOEF>":
            tk.next()
            return (tk.get_int() - 1, None)
        # DiagC GMM
        n_mix = 1
        if t and t.upper() == "<NUMMIXES>":
            tk.next()
            n_mix = tk.get_int()
        weights = np.ones(n_mix, np.float32)
        means, variances, gconsts = [None] * n_mix, [None] * n_mix, \
            [None] * n_mix
        mix = 0
        while True:
            t = tk.peek()
            if t is None:
                break
            u = t.upper()
            if u == "<MIXTURE>":
                tk.next()
                mix = tk.get_int() - 1
                weights[mix] = tk.get_float()
            elif u == "<MEAN>":
                tk.next()
                d = tk.get_int()
                means[mix] = tk.get_floats(d)
            elif u == "<VARIANCE>":
                tk.next()
                d = tk.get_int()
                variances[mix] = tk.get_floats(d)
            elif u == "<GCONST>":
                tk.next()
                gconsts[mix] = tk.get_float()
            else:
                break
        d = len(means[0])
        for m in range(n_mix):
            if variances[m] is None:
                variances[m] = np.ones(d, np.float32)
            if gconsts[m] is None:
                gconsts[m] = np.float32(
                    d * np.log(2 * np.pi) + np.log(variances[m]).sum())
        gmm = GMMState(weights, np.stack(means), np.stack(variances),
                       np.asarray(gconsts, np.float32))
        return (None, gmm)

    def parse_transp() -> np.ndarray:
        n = tk.get_int()
        mat = tk.get_floats(n * n).reshape(n, n)
        return _log_probs(mat)

    while tk.peek() is not None:
        t = tk.next()
        u = t.upper()
        if u == "~O":
            while tk.peek() and tk.peek().startswith("<"):
                kw = tk.next().upper()
                if kw == "<VECSIZE>":
                    vec_size = tk.get_int()
                elif kw == "<PDFOBSVEC>":
                    pdf_obs_vec = True
                # ignore <DIAGC>, <NULLD>, parameter-kind keywords
        elif u == "~S":
            name = tk.next().strip('"')
            shared_states[name] = parse_state_body()
        elif u == "~T":
            name = tk.next().strip('"')
            tk.expect("<TRANSP>")
            shared_trans[name] = parse_transp()
        elif u == "~H":
            name = tk.next().strip('"')
            tk.expect("<BEGINHMM>")
            tk.expect("<NUMSTATES>")
            n_states = tk.get_int()
            hmm = HmmDef(name=name, n_states=n_states,
                         obs_coefs=[None] * (n_states - 2),
                         gmm_states=[None] * (n_states - 2))
            while True:
                t2 = tk.next()
                u2 = t2.upper()
                if u2 == "<STATE>":
                    idx = tk.get_int() - 2      # emitting states are 2..N-1
                    oc, gmm = parse_state_body()
                    hmm.obs_coefs[idx] = oc
                    hmm.gmm_states[idx] = gmm
                elif u2 == "<TRANSP>":
                    hmm.log_transp = parse_transp()
                elif u2 == "~T":
                    hmm.log_transp = shared_trans[tk.next().strip('"')]
                elif u2 == "<ENDHMM>":
                    break
                else:
                    raise ValueError(f"unexpected token in HMM body: {t2}")
            if hmm.log_transp is None:
                raise ValueError(f"HMM {name} missing <TRANSP>")
            hmms[name] = hmm
        # ignore anything else silently (macros we don't model)

    from phnrec_tpu_torch.io.xform import parse_mmf_xforms

    xmacros, jmacros, input_xform = parse_mmf_xforms(path)
    return ModelSet(vec_size=vec_size, pdf_obs_vec=pdf_obs_vec, hmms=hmms,
                    xforms=xmacros or None,
                    xform_instances=jmacros or None,
                    input_xform=input_xform)


# -- MMF writer (Models_IO.cc WriteMmf / WriteHmm / WriteState) -------------

def _fmt(v: float) -> str:
    return f"{float(v):.6e}"


def write_mmf(models: ModelSet, path: str) -> None:
    """Write a ModelSet back to HTK MMF text, round-trippable through
    parse_mmf — the training loop's persistence step (the reference's
    ModelSet::WriteMmf, Models_IO.cc:1900+).  Transition matrices are
    written in probability domain (exp of the stored logs; LOG_0 -> 0)."""
    import numpy as np

    with open(path, "w") as f:
        opts = f"~o <VecSize> {models.vec_size}"
        opts += " <PDFObsVec>" if models.pdf_obs_vec else " <DIAGC>"
        f.write(opts + "\n")
        for name, h in models.hmms.items():
            f.write(f'~h "{name}"\n<BeginHMM>\n')
            f.write(f"<NumStates> {h.n_states}\n")
            for i in range(h.n_states - 2):
                f.write(f"<State> {i + 2}")
                oc = h.obs_coefs[i]
                g = h.gmm_states[i]
                if oc is not None:
                    f.write(f" <ObsCoef> {oc + 1}\n")
                elif g is not None:
                    f.write("\n")
                    m = g.weights.shape[0]
                    if m > 1:
                        f.write(f"<NumMixes> {m}\n")
                    for k in range(m):
                        if m > 1:
                            f.write(f"<Mixture> {k + 1} {_fmt(g.weights[k])}\n")
                        d = g.means.shape[1]
                        f.write(f"<Mean> {d}\n")
                        f.write(" ".join(_fmt(v) for v in g.means[k]) + "\n")
                        f.write(f"<Variance> {d}\n")
                        f.write(" ".join(_fmt(v) for v in g.variances[k])
                                + "\n")
                        f.write(f"<GConst> {_fmt(g.gconsts[k])}\n")
                else:
                    raise ValueError(
                        f"HMM {name!r} state {i + 2} has no output pdf")
            n = h.n_states
            f.write(f"<TransP> {n}\n")
            prob = np.where(h.log_transp > LOG_0,
                            np.exp(np.minimum(h.log_transp, 0.0)), 0.0)
            for r in range(n):
                f.write(" ".join(_fmt(v) for v in prob[r]) + "\n")
            f.write("<EndHMM>\n")
