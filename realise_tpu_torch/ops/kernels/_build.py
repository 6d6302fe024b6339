"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for sm_90a into ``build/realise_tpu_torch/lib<name>.so`` beside
the package (``build/`` is ignored by git). A library is rebuilt when the
hash of its source, of every ``csrc/*.cuh`` header it includes (directly or
through another header) and of the flags changes, and is loaded with
``ctypes``. Nothing happens at import time: the first CUDA launch builds and
loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "realise_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, transitively."""
    seen: List[Path] = []
    todo = [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC_DIR / inc.decode()
            if dep.is_file():
                todo.append(dep)
    return seen


def _paths(name: str):
    files = sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in files:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()
    return files[0], BUILD_DIR / f"lib{name}.so", BUILD_DIR / f"lib{name}.sha256", digest


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale library of ``names``, one ``nvcc`` per source, all
    started together. Returns {name: compiler log} for the ones built."""
    procs = {}
    for name in names:
        src, lib, stamp, digest = _paths(name)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        procs[name] = (subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, stamp, digest)
    logs, failed = {}, []
    for name, (proc, tmp, lib, stamp, digest) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, lib)
        stamp.write_text(digest)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if stale."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _LIBS[name]
