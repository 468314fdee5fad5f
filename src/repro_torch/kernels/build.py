"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` exposes plain C functions (no PyTorch
headers, so a build takes seconds) and compiles alone into
``build/kernels/<name>-<hash>.so`` under the repository root, a directory
that ``.gitignore`` lists.  The hash covers the source, the headers beside
it and the flags, so an edited kernel builds anew and an unchanged one is
reused.  A kernel builds the first time its wrapper launches it;
:func:`build` builds several at once, one ``nvcc`` for each source, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

SOURCES: Dict[str, str] = {"fedavg": "fedavg.cu", "dp_clip": "dp_clip.cu",
                           "boundary_fuse": "boundary_fuse.cu",
                           "agg_fuse": "agg_fuse.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only "
            "where the CUDA toolkit is installed")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where ``name``'s shared library lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None,
          timeout_s: float = 600.0) -> Dict[str, float]:
    """Build every kernel in ``names`` (default: all) that has no library
    for its current source; returns the seconds each build took (0.0 for a
    reused library).  ``nvcc``'s report (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    seconds = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for n, (proc, tmp, out, log) in procs.items():
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        finally:
            log.close()
        seconds[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{n} (exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
            continue
        # rename into place: a concurrent builder never loads a torn file
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s report from the build of ``name``'s current library."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
