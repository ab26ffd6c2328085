"""Build the package's CUDA kernels into plain-C shared libraries.

Each `csrc/<name>.cu` compiles with its own `nvcc` process for `sm_90a`
into `build/kernels/lib<name>-<hash>.so` at the repository root, where
`<hash>` covers the source, every file of `csrc/` that it includes
(`#include "..."`, followed recursively) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. `build_all` starts every compile at once
and waits for all of them. The libraries expose `extern "C"` entry
points taking raw pointers and a stream, loaded with `ctypes`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def kernel_names():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: Dict[Path, None]) -> Dict[Path, None]:
    """`path` and the files of `csrc/` it includes, recursively, in the
    order first met."""
    seen[path] = None
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = (path.parent / inc.decode()).resolve()
        if dep.is_file() and dep.is_relative_to(CSRC.resolve()) and \
                dep not in seen:
            _sources(dep, seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for path in _sources((CSRC / f"{name}.cu").resolve(), {}):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one `nvcc` each, all in parallel. Returns {name: compiler log}, where
    the log holds `ptxas`'s register and shared-memory summary (empty for
    a library that was already built). Raises if any compile fails."""
    names = list(names) if names is not None else kernel_names()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)      # atomic: parallel builders may race
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def ptx_opcodes(name: str) -> Counter:
    """How often each PTX opcode (`mul.rn.f64`, `fma.rn.f64`, ...) occurs
    in what nvcc's front end makes of `csrc/<name>.cu` for sm_90a: what the
    source asked for, before `ptxas` lowers it (the library embeds no
    PTX). The file is written beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name).with_suffix(".ptx")
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_nvcc(), "-arch=compute_90a", "-std=c++17", "-ptx",
                        "-o", str(tmp), str(CSRC / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    ops = Counter()
    for line in out.read_text().splitlines():   # [@%p1] opcode operands;
        words = line.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words and words[0][0].isalpha() and not line.rstrip().endswith(
                ("{", ":")):
            ops[words[0].rstrip(";")] += 1
    return ops


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
