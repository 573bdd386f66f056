"""Shell-style filename pattern matching with HTK '%' extraction.

Equivalent of STKLib/filmatch.{C,h}: patterns use

  ?      any single character
  %      any single character, CAPTURED — the concatenation of all %
         matches is the extracted string (HTK output-file masks use this,
         e.g. '%%%*' extracting a speaker id prefix)
  *      any run of characters (including empty)
  [..]   member / [!..] exclusion classes with '-' ranges and '\\'
         escapes — disabled (treated literally) in HTK-compatible mode,
         as in filmatch.C:48 (gHtkCompatible)

match() returns the extracted '%' capture on success (possibly the empty
string) and None on mismatch, combining filmatch's MATCH_VALID result and
its extraction side channel.  Copy of phnrec_tpu/utils/filmatch.py.
"""

from __future__ import annotations

from typing import Optional, Tuple


def is_pattern(p: str, htk_compatible: bool = True) -> bool:
    for i, c in enumerate(p):
        if c in "?*%":
            return True
        if c == "[" and not htk_compatible:
            return True
    return False


def _match_class(p: str, i: int, c: str) -> Tuple[bool, int]:
    """Match char c against the [..] construct starting at p[i] == '['.
    Returns (matched, index past ']'); raises ValueError on malformed."""
    i += 1
    invert = False
    if i < len(p) and p[i] in "!^":
        invert = True
        i += 1
    if i >= len(p) or p[i] == "]":
        raise ValueError("malformed [..] pattern")
    member = False
    while i < len(p) and p[i] != "]":
        if p[i] == "\\":
            i += 1
            if i >= len(p):
                raise ValueError("malformed [..] pattern")
        start = end = p[i]
        if i + 1 < len(p) and p[i + 1] == "-" and i + 2 < len(p) \
                and p[i + 2] != "]":
            j = i + 2
            if p[j] == "\\":
                j += 1
                if j >= len(p):
                    raise ValueError("malformed [..] pattern")
            end = p[j]
            i = j
        if start <= c <= end or end <= c <= start:
            member = True
        i += 1
    if i >= len(p):
        raise ValueError("unterminated [..] pattern")
    return member != invert, i + 1


def _matche(p: str, t: str, htk_compatible: bool) -> Optional[str]:
    pi = ti = 0
    out = []
    while pi < len(p):
        if ti >= len(t):
            # text exhausted: only a trailing lone '*' still matches
            return "".join(out) if p[pi:] == "*" else None
        c = p[pi]
        if c == "?":
            pass
        elif c == "%":
            out.append(t[ti])
        elif c == "*":
            # try every split for the star (filmatch's matche_after_star)
            while pi < len(p) and p[pi] == "*":
                pi += 1
            if pi >= len(p):
                return "".join(out)
            for skip in range(ti, len(t) + 1):
                sub = _matche(p[pi:], t[skip:], htk_compatible)
                if sub is not None:
                    return "".join(out) + sub
            return None
        elif c == "[" and not htk_compatible:
            ok, pi2 = _match_class(p, pi, t[ti])
            if not ok:
                return None
            pi = pi2
            ti += 1
            continue
        elif c == "\\" and not htk_compatible and pi + 1 < len(p):
            pi += 1
            if p[pi] != t[ti]:
                return None
        else:
            if c != t[ti]:
                return None
        pi += 1
        ti += 1
    return "".join(out) if ti == len(t) else None


def match(pattern: str, text: str,
          htk_compatible: bool = True) -> Optional[str]:
    """None if no match; else the string captured by the '%' wildcards."""
    return _matche(pattern, text, htk_compatible)


def fnmatch(pattern: str, text: str, htk_compatible: bool = True) -> bool:
    return match(pattern, text, htk_compatible) is not None
