"""Typed INI configuration, compatible with PhnRec model-package `config` files.

Copy of phnrec_tpu/config.py (numpy-free host code, kept in step with it).

Mirrors the reference's two-piece design (configz.{cpp,h} + the variable table
in srec.cpp:34-110): every settable variable is declared up front with a
section, name, type and default; loading an INI checks values against the
table and rejects unknown variables; `$C` (config dir) and `$T` (tmp dir)
macros are substituted into path-valued entries (srec.cpp:219-233,268-332).

INI dialect (configz.cpp:102-166):
  - `[section]` headers; `#` starts a comment line; empty lines ignored
  - `key=value` with NO whitespace trimming around `=`
  - on a value line, text after `#` is dropped (strtok(0, "#"))
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

# type tags (ref configz.h: CE_STRING/CE_BOOL/CE_INT/CE_FLOAT)
STRING, BOOL, INT, FLOAT = "string", "bool", "int", "float"


@dataclass(frozen=True)
class ConfigVar:
    section: str
    name: str
    type: str
    default: str


# The reference's full variable table, srec.cpp:34-110 (defaults verbatim).
CONFIG_VARIABLES: Tuple[ConfigVar, ...] = tuple(
    ConfigVar(s, n, t, d)
    for (s, n, t, d) in [
        ("source", "format", STRING, "lin16"),
        ("source", "sample_freq", INT, "8000"),
        ("source", "scale", FLOAT, "1.0"),
        ("source", "dc_shift", FLOAT, "0.0"),
        ("source", "noise_level", FLOAT, "0.0"),
        ("params", "kind", STRING, "fbanks"),
        ("params", "suffix", STRING, "mel"),
        ("melbanks", "nbanks", INT, "15"),
        ("melbanks", "nbanks_full", INT, "-1"),
        ("melbanks", "lower_freq", FLOAT, "0"),
        ("melbanks", "higher_freq", FLOAT, "4000"),
        ("melbanks", "vector_size", INT, "200"),
        ("melbanks", "vector_step", INT, "80"),
        ("melbanks", "preem_coef", FLOAT, "0.0"),
        ("melbanks", "z_mean_source", BOOL, "false"),
        ("plp", "order", INT, "12"),
        ("plp", "compress_fact", FLOAT, "0.3333333"),
        ("plp", "cep_lifter", FLOAT, "22"),
        ("plp", "cep_scale", FLOAT, "10"),
        ("plp", "add_c0", BOOL, "false"),
        ("onlinenorm", "estim_interval", INT, "0"),
        ("onlinenorm", "signal_est_end", BOOL, "false"),
        ("onlinenorm", "file", STRING, "none"),
        ("onlinenorm", "mean_norm", BOOL, "false"),
        ("onlinenorm", "var_norm", BOOL, "false"),
        ("onlinenorm", "scale_to_gvar", BOOL, "false"),
        ("offlinenorm", "sent_mean_norm", BOOL, "false"),
        ("offlinenorm", "sent_var_norm", BOOL, "false"),
        ("offlinenorm", "sent_std_thr", FLOAT, "0.01"),
        ("offlinenorm", "sent_max_norm", BOOL, "false"),
        ("offlinenorm", "sent_chmax_norm", BOOL, "false"),
        ("framenorm", "min_floor", FLOAT, "-9999.9"),
        ("framenorm", "shift", FLOAT, "0"),
        ("posteriors", "system", STRING, "1BT_DCT"),
        ("posteriors", "length", INT, "31"),
        ("posteriors", "add_c0", BOOL, "true"),
        ("posteriors", "hamming", BOOL, "false"),
        ("posteriors", "suffix", STRING, "lop"),
        # declared CE_STRING but read as int in the reference (srec.cpp:74,620)
        ("posteriors", "bunch_size", STRING, "1"),
        ("posteriors", "enabled", BOOL, "true"),
        ("posteriors", "softening_func", STRING, "none 0 0 0"),
        ("decoder", "type", STRING, "stkint"),
        ("decoder", "wpenalty", FLOAT, "-2.0"),
        ("decoder", "lm_scale", FLOAT, "1.0"),
        ("decoder", "time_pruning", INT, "40"),
        ("decoder", "mode", STRING, "decode"),
        ("decoder", "softening_func", STRING, "log 0 0 0"),
        ("decoder", "num_states_per_phn", INT, "1"),
        # EXTENSION keys (not in srec.cpp:34-110): the reference engine
        # has these knobs only as C++ setters (stkinterface.h:107-113,
        # defaults off stkinterface.cpp:26,33); exposing them as config
        # is additive — shipped configs never set them.
        ("decoder", "beam_pruning", FLOAT, "0.0"),
        ("kws", "score_pruning", FLOAT, "-1e30"),
        # EXTENSION: initial online-norm channel for multi-channel
        # sources (the reference exposes Normalization::SetChannel,
        # norm.h:49/norm.cpp:202, but never wires it to config;
        # StreamingRecognizer.set_channel switches mid-stream)
        ("onlinenorm", "channel", INT, "0"),
        ("dirs", "tmp", STRING, "$C/tmp"),
        ("models", "hmm_defs", STRING, "$T/models"),
        ("models", "nstates", INT, "3"),
        ("models", "gen_from_phn_list", BOOL, "false"),
        ("dicts", "phoneme_list", STRING, ""),
        ("dicts", "lexicon1", STRING, ""),
        ("dicts", "lexicon2", STRING, ""),
        ("dicts", "lexicon1_save_bin", BOOL, "false"),
        ("dicts", "lexicon2_save_bin", BOOL, "false"),
        ("dicts", "keyword_list", STRING, "none"),
        ("dicts", "charset", STRING, "eastevrope"),
        ("networks", "default", STRING, "$C/nets/network"),
        ("networks", "gen_phn_loop", BOOL, "false"),
        ("networks", "gen_kws_net", BOOL, "false"),
        ("networks", "omit_phn", STRING, "oth"),
        ("labels", "suffix", STRING, "rec"),
        ("labels", "remove_path", BOOL, "true"),
        ("kws", "default_thr", FLOAT, "-10.0"),
        ("kws", "thresholds_file", STRING, "none"),
        ("gptransc", "rules", STRING, "none"),
        ("gptransc", "symbols", STRING, "none"),
        ("gptransc", "max_variants", INT, "-1"),
        ("gptransc", "scale_prob", BOOL, "false"),
        ("gptransc", "prob_thr", FLOAT, "-1.0"),
        ("phntransc", "mode", STRING, "lexgpt"),
    ]
)

_VAR_INDEX: Dict[Tuple[str, str], ConfigVar] = {
    (v.section, v.name): v for v in CONFIG_VARIABLES
}

# Config entries holding paths that undergo $C/$T substitution (srec.cpp:268-332).
_PATH_KEYS = [
    ("models", "hmm_defs"),
    ("dicts", "phoneme_list"),
    ("networks", "default"),
    ("dicts", "lexicon1"),
    ("dicts", "lexicon2"),
    ("dicts", "keyword_list"),
    ("kws", "thresholds_file"),
    ("gptransc", "rules"),
    ("gptransc", "symbols"),
    ("onlinenorm", "file"),
]


class ConfigError(Exception):
    def __init__(self, msg: str, line: int = -1):
        super().__init__(msg if line < 0 else f"{msg} (line {line})")
        self.line = line


def _check_value(var: ConfigVar, value: str, line: int) -> None:
    if var.type == INT:
        try:
            _parse_leading_int(value)
        except ValueError:
            raise ConfigError(f"invalid int for {var.section}/{var.name}: {value!r}", line)
    elif var.type == FLOAT:
        try:
            _parse_leading_float(value)
        except ValueError:
            raise ConfigError(f"invalid float for {var.section}/{var.name}: {value!r}", line)
    elif var.type == BOOL:
        if value not in ("true", "false"):
            raise ConfigError(f"invalid bool for {var.section}/{var.name}: {value!r}", line)


def _parse_leading_int(s: str) -> int:
    # sscanf("%d") semantics: leading whitespace, optional sign, digits.
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        raise ValueError(s)
    return int(s[: j])


def _parse_leading_float(s: str) -> float:
    # sscanf("%f") semantics: parse the longest valid leading float.
    s = s.strip()
    best = None
    for j in range(len(s), 0, -1):
        try:
            best = float(s[:j])
            break
        except ValueError:
            continue
    if best is None:
        raise ValueError(s)
    return best


@dataclass
class PhnRecConfig:
    """Typed key-value store seeded with the reference's defaults.

    Use :meth:`load` / :meth:`load_package` to read a model package's INI.
    """

    entries: Dict[Tuple[str, str], str] = field(default_factory=dict)
    check_unknown: bool = True
    config_dir: str = ""

    def __post_init__(self):
        if not self.entries:
            for v in CONFIG_VARIABLES:
                self.entries[(v.section, v.name)] = v.default

    # -- typed accessors (configz.cpp:198-275) ------------------------------
    def get_str(self, section: str, name: str) -> str:
        key = (section, name)
        if key not in self.entries:
            raise KeyError(f"config entry [{section}] {name} was never set")
        return self.entries[key]

    def get_bool(self, section: str, name: str) -> bool:
        return self.get_str(section, name) == "true"

    def get_int(self, section: str, name: str) -> int:
        return _parse_leading_int(self.get_str(section, name))

    def get_float(self, section: str, name: str) -> float:
        return _parse_leading_float(self.get_str(section, name))

    def set_str(self, section: str, name: str, value: str) -> None:
        self.entries[(section, name)] = value

    def set_int(self, section: str, name: str, value: int) -> None:
        self.set_str(section, name, str(value))

    def set_float(self, section: str, name: str, value: float) -> None:
        self.set_str(section, name, f"{value:f}")

    def set_bool(self, section: str, name: str, value: bool) -> None:
        self.set_str(section, name, "true" if value else "false")

    # -- INI loading (configz.cpp:102-166) ----------------------------------
    def load(self, path: str) -> None:
        with open(path, "r", encoding="latin-1") as f:
            lines = f.read().splitlines()
        section = ""
        for lineno, raw in enumerate(lines, start=1):
            line = raw.rstrip("\r\n")
            if len(line) > 1 and line[0] == "[":
                section = line[1:-1] if line.endswith("]") else line[1:]
            elif line.startswith("#") or len(line) == 0:
                continue
            else:
                # strtok(buff, "=") / strtok(0, "#"): no whitespace trimming
                if "=" not in line:
                    raise ConfigError(f"invalid line: {line!r}", lineno)
                name, _, rest = line.partition("=")
                value = rest.split("#", 1)[0]
                if name == "" or value == "":
                    raise ConfigError(f"invalid line: {line!r}", lineno)
                var = _VAR_INDEX.get((section, name))
                if var is None:
                    if self.check_unknown:
                        raise ConfigError(
                            f"unknown variable [{section}] {name}", lineno
                        )
                else:
                    _check_value(var, value, lineno)
                self.entries[(section, name)] = value

    def substitute_paths(self, config_dir: str) -> None:
        """$C/$T macro expansion over path-valued entries (srec.cpp:219-233)."""
        self.config_dir = config_dir
        tmp = self.get_str("dirs", "tmp")
        if tmp.startswith("$C"):
            tmp = config_dir + tmp[2:]
        self.set_str("dirs", "tmp", tmp)
        for section, name in _PATH_KEYS:
            val = self.get_str(section, name)
            if len(val) > 1 and val[:2] in ("$C", "$T"):
                base = config_dir if val[1] == "C" else self.get_str("dirs", "tmp")
                self.set_str(section, name, base + val[2:])

    @classmethod
    def load_package(cls, config_dir: str) -> "PhnRecConfig":
        """Load `<config_dir>/config` and expand $C/$T, like SpeechRec::Init."""
        cfg = cls()
        cfg.load(os.path.join(config_dir, "config"))
        cfg.substitute_paths(config_dir)
        return cfg

    # -- convenience --------------------------------------------------------
    def save(self, path: str) -> None:
        by_section: Dict[str, Dict[str, str]] = {}
        for (section, name), value in sorted(self.entries.items()):
            by_section.setdefault(section, {})[name] = value
        with open(path, "w", encoding="latin-1") as f:
            first = True
            for section, vals in by_section.items():
                if not first:
                    f.write("\n")
                first = False
                f.write(f"[{section}]\n")
                for name, value in vals.items():
                    f.write(f"{name}={value}\n")
