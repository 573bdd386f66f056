"""The port's public surface held to phnrec_tpu's, so that nothing goes
missing: every public top-level function and class of every phnrec_tpu
module, and every public method of those classes (the protocol dunders
included: ``__call__``, ``__iter__``, ...), is defined by the port's
counterpart module.  Both packages are read with ``ast``; neither is
imported.  Every ``examples/*.py`` has a twin in
``phnrec_tpu_torch/examples/``.

The port's entry points run on the card unless the caller asks for the
CPU: no public function or constructor of the port defaults its
``device`` to the CPU (but the helpers in ``CPU_DEFAULT_OK``), and each
twin of ``examples/`` builds its recognizer or trainer on ``cuda`` when
``--device`` is not given."""

import ast
import inspect
from pathlib import Path

import pytest

import phnrec_tpu_torch
from phnrec_tpu_torch.decoder.stknet import (DeviceKWSTracker,
                                             StkNetworkDecoder)
from phnrec_tpu_torch.examples import (batch_decode, keyword_spotting,
                                       multistream_serving,
                                       streaming_decode, train_gmm_hmm)
from phnrec_tpu_torch.io.xform import StreamingXform
from phnrec_tpu_torch.pipeline import SpeechRec
from phnrec_tpu_torch.train.loop import Reestimator

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "phnrec_tpu"
PORT = Path(phnrec_tpu_torch.__file__).parent

# phnrec_tpu module -> the port's modules that take its names, where the
# port's file is named otherwise (the Pallas kernels' wrappers)
MODULES = {
    "ops/pallas_mlp.py": ("ops/mlp_fused.py", "ops/mlp_bf16x3.py"),
    "ops/pallas_netstep.py": ("ops/netstep.py",),
}
# (module, name) -> (port module, name) where the port names it otherwise
RENAMED = {
    # kernel A (float32) and A′ (bf16 passes): one wrapper a kernel, the
    # precision mode choosing between them in posteriors/mlp.py
    ("ops/pallas_mlp.py", "mlp_forward_fused"): ("ops/mlp_fused.py",
                                                 "mlp_forward"),
}
# (module, name) of phnrec_tpu kept out of the port, each with its reason
KEPT_OUT = {
    # the JAX package's padded-weights pytree, the function that makes it
    # and its forward function (lane padding to 128, lax.Precision); the
    # port's MLP module (posteriors/mlp.py) and precision.mlp_passes stand
    # in for them (ROADMAP.md Queue 1)
    ("posteriors/mlp.py", "MLPDevice"),
    ("posteriors/mlp.py", "to_device"),
    ("posteriors/mlp.py", "forward"),
    # returns a jax.lax.Precision for jnp.dot; the port keeps float32 with
    # TF32 off outside the MLPs and reads the mode by mlp_passes
    ("precision.py", "get"),
}
# public functions of the port whose ``device`` defaults to the CPU: each
# takes the caller's device (a tensor's or a module's) and is called with
# it on every path
CPU_DEFAULT_OK = {
    # the carries of the scans, made where the decoder's tensors live
    "decoder/phnloop.py:init_carry",
    "decoder/stknet.py:NetworkDecoder.init_carry",
    "decoder/stknet.py:DenseKWSScan.init_carry",
    "decoder/stknet.py:DenseKWSScan.init_carry_decode",
    "decoder/stknet.py:lrtrace_init_state",
    "io/xform.py:xform_init_state",
    "io/xform.py:instance_init_state",
    # the tests' converter of phnrec_tpu's accumulators
    "convert.py:accumulators_from_numpy",
}


def _public(name: str) -> bool:
    return not name.startswith("_") or (
        name.startswith("__") and name.endswith("__")
        and name != "__init__")


def _jax_surface(path: Path):
    """{name: None for a function, {methods} for a class} of the public
    top-level definitions of a phnrec_tpu module."""
    out = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            out[n.name] = None
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            out[n.name] = {m.name for m in n.body
                           if isinstance(m, ast.FunctionDef)
                           and _public(m.name)}
    return out


def _port_surface(paths):
    """(top-level names, {class: (methods, base names)}) of the port's
    modules: definitions, assignments and imports."""
    names, classes = set(), {}
    for path in paths:
        for n in ast.parse(path.read_text()).body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(n.name)
            elif isinstance(n, ast.ClassDef):
                names.add(n.name)
                methods = {m.name for m in n.body if isinstance(
                    m, (ast.FunctionDef, ast.AsyncFunctionDef))}
                methods |= {m.target.id for m in n.body
                            if isinstance(m, ast.AnnAssign)
                            and isinstance(m.target, ast.Name)}
                classes[n.name] = (methods,
                                   [ast.unparse(b) for b in n.bases])
            elif isinstance(n, ast.Assign):
                names |= {t.id for t in n.targets
                          if isinstance(t, ast.Name)}
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                names |= {(a.asname or a.name).split(".")[0]
                          for a in n.names}
    return names, classes


def _methods(classes, name):
    """A port class's methods with those of its bases in the same module;
    an nn.Module's ``forward`` is its ``__call__``."""
    methods, bases = classes[name]
    methods = set(methods)
    for b in bases:
        if b in classes:
            methods |= _methods(classes, b)
        if b in ("nn.Module", "torch.nn.Module") and "forward" in methods:
            methods.add("__call__")
    return methods


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_defines_every_public_name(module):
    want = _jax_surface(JAX_PKG / module)
    paths = [PORT / m for m in MODULES.get(module, (module,))]
    assert all(p.is_file() for p in paths), f"no port module for {module}"
    names, classes = _port_surface(paths)
    missing = []
    for name, methods in want.items():
        if (module, name) in KEPT_OUT:
            continue
        if (module, name) in RENAMED:
            pmod, pname = RENAMED[(module, name)]
            if pname not in _port_surface([PORT / pmod])[0]:
                missing.append(f"{name} (as {pmod}:{pname})")
            continue
        if name not in names:
            missing.append(name)
            continue
        if methods:
            if name not in classes:
                missing.append(f"{name} (not a class)")
                continue
            missing += [f"{name}.{m}" for m in
                        sorted(methods - _methods(classes, name))]
    assert not missing, f"{module}: the port lacks {missing}"


def test_kept_out_names_exist_in_phnrec_tpu():
    """Every entry of KEPT_OUT and RENAMED names a public definition of
    phnrec_tpu, and none of KEPT_OUT is in the port after all."""
    for module, name in KEPT_OUT | set(RENAMED):
        assert name in _jax_surface(JAX_PKG / module), (module, name)
    for module, name in KEPT_OUT:
        paths = [PORT / m for m in MODULES.get(module, (module,))]
        assert name not in _port_surface(paths)[0], (module, name)


def test_every_example_has_a_twin():
    originals = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert len(originals) == 5
    for name in originals:
        twin = PORT / "examples" / name
        assert twin.is_file(), name
        tree = ast.parse(twin.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "main"
                   for n in tree.body), name


def _device_defaults():
    """(module:qualified name, default) of every public function and
    method of the port (devtools aside) with a ``device`` parameter."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = str(path.relative_to(PORT))
        if rel.startswith("devtools/"):
            continue

        def visit(body, prefix):
            for n in body:
                if isinstance(n, ast.ClassDef) and not n.name.startswith(
                        "_"):
                    visit(n.body, prefix + n.name + ".")
                elif isinstance(n, ast.FunctionDef) and (
                        not n.name.startswith("_") or n.name == "__init__"):
                    a = n.args
                    pos = a.posonlyargs + a.args
                    defaults = dict(zip([x.arg for x in pos][
                        len(pos) - len(a.defaults):], a.defaults))
                    defaults.update({k.arg: d for k, d in
                                     zip(a.kwonlyargs, a.kw_defaults)})
                    if any(x.arg == "device" for x in pos + a.kwonlyargs):
                        d = defaults.get("device")
                        out.append((f"{rel}:{prefix}{n.name}",
                                    None if d is None else ast.literal_eval(d)))
        visit(ast.parse(path.read_text()).body, "")
    return out


def test_no_public_entry_point_defaults_to_the_cpu():
    found = _device_defaults()
    assert len(found) > 20
    cpu = {name for name, d in found if d == "cpu"}
    assert cpu == CPU_DEFAULT_OK, sorted(cpu ^ CPU_DEFAULT_OK)


@pytest.mark.parametrize("cls", [SpeechRec, Reestimator, StkNetworkDecoder,
                                 DeviceKWSTracker, StreamingXform],
                         ids=lambda c: c.__name__)
def test_constructors_default_to_cuda(cls):
    assert inspect.signature(cls.__init__).parameters[
        "device"].default == "cuda"


class _Built(Exception):
    pass


@pytest.mark.parametrize("module,cls,args", [
    (batch_decode, "SpeechRec", ["PKG", "OUT", "a.raw"]),
    (streaming_decode, "SpeechRec", ["PKG", "a.raw"]),
    (keyword_spotting, "SpeechRec", ["PKG", "a.raw", "kw=a b"]),
    (multistream_serving, "SpeechRec", ["PKG", "a.raw"]),
    (train_gmm_hmm, "Reestimator", []),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_twins_default_to_cuda(module, cls, args, monkeypatch, tmp_path):
    """Without --device a twin builds its SpeechRec or Reestimator on
    ``cuda``; with --device, on that device."""
    seen = []

    def built(*a, device=None, **kw):
        seen.append(device)
        raise _Built

    monkeypatch.setattr(module, cls, built)
    monkeypatch.chdir(tmp_path)
    for argv, want in ((args, "cuda"), (["--device", "cpu", *args], "cpu")):
        with pytest.raises(_Built):
            module.main(argv)
        assert seen[-1] == want
