"""Build the hand-written CUDA kernels of csrc/ and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use by ``nvcc`` for ``sm_90a`` into ``multistgraph_tpu_torch/_build/`` (a
git-ignored directory), under a file name keyed on a hash of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source is
rebuilt and a built one is reused. The build writes a temporary file and renames it into place, so processes that
build at once never load a half-written library. Nothing here runs at
import time: this module is imported on machines without nvcc or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("node_apply_q8", "node_apply_q8_t", "layout_copy", "bsr_spmm", "sampled_matmul", "band_spmm",
           "node_factored", "node_factored_t", "node_dots", "stream_read", "band_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The built library's path, keyed on the source, the shared headers of
    csrc/ and the flags."""
    text = (CSRC / (name + ".cu")).read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / "lib{}-{}.so".format(name, digest)


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns {name: compiler output} for what was built
    (ptxas register and shared-memory report); raises if a build fails."""
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name("{}.{}.tmp".format(target.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, target))
    reports = {}
    failed = []
    for name, proc, tmp, target in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed for {} (rc {}):\n{}".format(name, proc.returncode, out))
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
    return lib
