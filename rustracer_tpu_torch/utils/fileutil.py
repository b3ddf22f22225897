"""Search-path resolution for scene-relative files.

Reference: rustracer-core/src/fileutil.rs:11-49 — a global search directory
set from the scene file's location; filenames resolve against it.
"""
from __future__ import annotations

import os

_search_directory: str = ""


def set_search_directory(d: str):
    global _search_directory
    _search_directory = d or ""


def directory_containing(path: str) -> str:
    return os.path.dirname(os.path.abspath(path))


def resolve_filename(filename: str) -> str:
    if not filename or os.path.isabs(filename) or not _search_directory:
        return filename
    if os.path.exists(filename):
        return filename
    return os.path.join(_search_directory, filename)
