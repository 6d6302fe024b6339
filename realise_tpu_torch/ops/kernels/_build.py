"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for sm_90a into ``build/realise_tpu_torch/lib<name>.so`` beside
the package (``build/`` is ignored by git). The host libraries of
``HOST_SOURCES`` (the C++ featurizer) take the same road with the host's
C++ compiler. A library is rebuilt when the hash of its source, of every
local header it includes (directly or through another header) and of the
flags changes, and is loaded with ``ctypes``. Nothing happens at import
time: the first use builds and loads; a failed build raises with the
compiler's output.
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

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# Host libraries: library name → its C++ source in csrc/.
HOST_SOURCES = {"realise_featurizer": "featurizer.cpp"}

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


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH); "
                       "the native featurizer is built from source at first "
                       "use")


def _command(name: str, src: Path, out: Path) -> List[str]:
    if name in HOST_SOURCES:
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(src)]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[Path]:
    """The source of library ``name`` (``csrc/<name>.cu``, or its entry of
    ``HOST_SOURCES``) and the local headers it includes, transitively."""
    seen: List[Path] = []
    todo = [CSRC_DIR / HOST_SOURCES.get(name, f"{name}.cu")]
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
    flags = CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()
    return files[0], BUILD_DIR / f"lib{name}.so", BUILD_DIR / f"lib{name}.sha256", digest


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every stale library of ``names``, one compiler per source, all
    started together. Returns {name: compiler log} for the ones built."""
    procs = {}
    for name in names:
        src, lib, stamp, digest = _paths(name)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        procs[name] = (subprocess.Popen(
            _command(name, src, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            src, tmp, lib, stamp, digest)
    logs, failed = {}, []
    for name, (proc, src, tmp, lib, stamp, digest) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"the build of {src.name} failed:\n{logs[name]}")
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
