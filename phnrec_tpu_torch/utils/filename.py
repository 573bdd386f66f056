"""File-name munging with the reference's exact semantics (filename.cpp).

Copy of phnrec_tpu/utils/filename.py (kept in step with it)."""

from __future__ import annotations


def change_file_suffix(file_name: str, new_suffix: str) -> str:
    """Replace text after the last '.' in the basename, or append
    '.suffix' when the basename has no dot (filename.cpp:30-46)."""
    dot = file_name.rfind(".")
    sep = max(file_name.rfind("/"), file_name.rfind("\\"))
    if dot == -1 or (sep != -1 and sep > dot):
        return file_name + "." + new_suffix
    return file_name[: dot + 1] + new_suffix


def change_file_path(file_name: str, new_path: str) -> str:
    """Replace the directory part (filename.cpp ChangeFilePath; MLF names
    use new_path='*', srec.cpp:1435)."""
    sep = max(file_name.rfind("/"), file_name.rfind("\\"))
    base = file_name[sep + 1 :] if sep != -1 else file_name
    return new_path + "/" + base if new_path else base


def cut_off_file_suffix(file_name: str) -> str:
    dot = file_name.rfind(".")
    sep = max(file_name.rfind("/"), file_name.rfind("\\"))
    if dot != -1 and (sep == -1 or dot > sep):
        return file_name[:dot]
    return file_name


def extract_file_name(file_name: str) -> str:
    sep = max(file_name.rfind("/"), file_name.rfind("\\"))
    return file_name[sep + 1 :] if sep != -1 else file_name
