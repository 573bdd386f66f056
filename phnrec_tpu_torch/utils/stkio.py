"""Pipe/filter file access — the stkstream / my_fopen conventions.

Equivalent of STKLib's my_fopen (common.C:1084-1110) and the pipe-capable
stkstream wrappers (stkstream.{h,tcc}):

  * name ``-``            stdin / stdout
  * name ``|command``     read from / write to a shell command's pipe
  * a configured filter   a shell command template whose ``$`` wildcard
                          (gpFilterWldcrd) is replaced by the filename and
                          whose stdout/stdin is the stream — e.g.
                          filter='gunzip -c $' reads gzipped feature files
                          transparently

Host-side file plumbing only; never on the device compute path.  Copy of
phnrec_tpu/utils/stkio.py.
"""

from __future__ import annotations

import io
import subprocess
import sys
from typing import IO, Optional

FILTER_WILDCARD = "$"      # gpFilterWldcrd


def expand_filter_command(command: str, filename: str) -> str:
    """Replace every ``$`` in the template with the filename
    (expandFilterCommand, common.C:1049-1073)."""
    return command.replace(FILTER_WILDCARD, filename)


class _PipeStream:
    """File-like wrapper that reaps the subprocess on close."""

    def __init__(self, proc: subprocess.Popen, stream: IO[bytes],
                 text: bool):
        self._proc = proc
        self._stream = io.TextIOWrapper(stream) if text else stream

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def close(self) -> None:
        self._stream.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return iter(self._stream)


def open_stream(file_name: str, mode: str = "r",
                filter_cmd: Optional[str] = None):
    """my_fopen semantics: '-', '|cmd', filter template, or a plain file.
    ``mode``: 'r'/'rb'/'w'/'wb'."""
    reading = mode.startswith("r")
    text = "b" not in mode
    if file_name == "-":
        if text:
            return sys.stdin if reading else sys.stdout
        return sys.stdin.buffer if reading else sys.stdout.buffer
    if file_name.startswith("|"):
        cmd = file_name[1:]
    elif filter_cmd:
        cmd = expand_filter_command(filter_cmd, file_name)
    else:
        return open(file_name, mode)
    proc = subprocess.Popen(
        cmd, shell=True,
        stdout=subprocess.PIPE if reading else None,
        stdin=subprocess.PIPE if not reading else None)
    stream = proc.stdout if reading else proc.stdin
    assert stream is not None
    return _PipeStream(proc, stream, text)
