"""Compile native sources of this package into shared libraries on first use.

Each library is built into ``build/rustracer_tpu_torch/<name>-<key>/`` beside
the package (a directory that version control ignores), keyed by a hash of
its sources and its command line, so an edited source or flag rebuilds and
an unchanged one loads the cached build. Concurrent builders (test workers)
write to a private temporary name and rename it into place atomically. A
library of several sources compiles each to an object file, all at once,
and links the objects.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PKG_DIR), "build",
                          "rustracer_tpu_torch")


def compile_shared(name: str, sources, command, timeout: float = 600.0):
    """Build ``lib<name>.so`` from ``sources`` (paths) with ``command`` (the
    compiler and its flags, without sources or ``-o``). Returns the path of
    the library. Raises RuntimeError with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sorted(sources):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    for hdr in sorted(os.listdir(CSRC)):
        if hdr.endswith((".cuh", ".h")):
            with open(os.path.join(CSRC, hdr), "rb") as f:
                h.update(hdr.encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    with tempfile.TemporaryDirectory(dir=out_dir) as obj_dir:
        inputs = list(sources)
        if len(inputs) > 1:
            compile_only = [a for a in command if a != "-shared"] + ["-c"]
            objs = [os.path.join(obj_dir, f"{i}.o")
                    for i in range(len(inputs))]
            procs = [subprocess.Popen(compile_only + [src, "-o", obj],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(inputs, objs)]
            for src, p in zip(inputs, procs):
                out, _ = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    for q in procs:
                        q.kill()
                    raise RuntimeError(f"building {name}: {src} failed "
                                       f"({' '.join(compile_only)}):\n{out}")
            inputs = objs
        proc = subprocess.run(list(command) + ["-o", tmp] + inputs,
                              capture_output=True, text=True,
                              timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(command)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib
