"""Build and bind the hand-written CUDA kernels of `mspl_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into its own shared library
under `mspl_tpu_torch/_build/`, then loaded with ctypes.  Nothing is built
when a module is imported: the first launch builds what it needs, and
`build_all()` compiles every source at once, one nvcc process per source
running in parallel.  A library's file name carries a hash of its source,
the headers it includes and the flags, so an edited kernel is rebuilt and
a stale one never loads, and a header's edit rebuilds only its includers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("pseudo_cm", "pseudo_cm_mixed", "pyrpool", "resize_x2",
           "eesp_branches", "eesp_stage", "pseudo_pm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of mspl_tpu_torch "
                           "need the CUDA toolkit to build")
    return found


def _inputs(name: str):
    """`csrc/<name>.cu` and every csrc header it includes, directly or
    through another header."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.append(path)
            todo += [CSRC / inc for inc in
                     re.findall(r'#include "(\w+\.cuh)"', path.read_text())]
    return seen


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _inputs(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every missing library, all nvcc processes at once; returns
    the wall seconds spent.  Each compiler log (registers, shared memory,
    spills from `-Xptxas -v`) is kept beside its library as `<name>.log`."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD / f"{name}.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.mspl_error_string.argtypes = [ctypes.c_int]
        lib.mspl_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.mspl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    """Wrapper-side checks the kernels rely on."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
