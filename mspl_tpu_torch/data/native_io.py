"""ctypes bindings for the native C++ PNG codec (port of
mspl_tpu/data/native_io.py).

The port compiles the repository's `native/mspl_io.cc` itself, at first
use, with `g++ -O3 -fPIC -shared -pthread ... -lz` into
`mspl_tpu_torch/_build/`, under a file name that carries a hash of the
source and the flags (as `ops/_cuda.py` names the CUDA libraries), so an
edited source is rebuilt and a stale library never loads.  A failed build
leaves its compiler output in `_build/mspl_io.log`.

Every entry point falls back to PIL, as the reference's do, when the
library cannot be built or loaded or a file is outside the codec's PNG
subset; `available()` says whether the native path is active.  The batch
decoder fills one preallocated uint8 [n, h, w, c] buffer from C++ threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = _REPO_ROOT / "native" / "mspl_io.cc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"libmspl_io_{h.hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    """Compile the codec; None (and the compiler's output in
    `_build/mspl_io.log`) when that fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = lib_path()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SRC), "-lz", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        log = proc.stdout + proc.stderr
        ok = proc.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as e:
        log, ok = f"{' '.join(cmd)}: {e}".encode(), False
    (BUILD / "mspl_io.log").write_bytes(log)
    if not ok:
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so = lib_path()
        if not so.exists():
            so = _build() if SRC.exists() else None
        if so is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.mspl_decode_png_file.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.mspl_decode_png_file.restype = ctypes.c_int
        lib.mspl_decode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.mspl_decode_png_batch.restype = ctypes.c_int
        lib.mspl_encode_png_file.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.mspl_encode_png_file.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_png(path: str, size_hw: Tuple[int, int], channels: int = 3,
               bilinear: bool = True) -> np.ndarray:
    """Decode (and resize) one PNG to uint8 [h, w, channels] (or [h, w])."""
    lib = _load()
    h, w = size_hw
    if lib is None:
        return _pil_decode(path, size_hw, channels, bilinear)
    out = np.empty((h, w, channels), np.uint8)
    rc = lib.mspl_decode_png_file(path.encode(), _u8(out), h, w, channels,
                                  1 if bilinear else 0)
    if rc != 0:
        return _pil_decode(path, size_hw, channels, bilinear)
    return out[..., 0] if channels == 1 else out


def decode_png_batch(paths: Sequence[str], size_hw: Tuple[int, int],
                     channels: int = 3, bilinear: bool = True,
                     num_threads: int = 8) -> np.ndarray:
    """Decode a batch of PNGs in parallel into one [n, h, w, c] buffer."""
    lib = _load()
    h, w = size_hw
    n = len(paths)
    if lib is None:
        return np.stack([
            np.atleast_3d(decode_png(p, size_hw, channels, bilinear))
            for p in paths])
    out = np.empty((n, h, w, channels), np.uint8)
    rcs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.mspl_decode_png_batch(
        arr, n, _u8(out), h, w, channels, 1 if bilinear else 0, num_threads,
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:  # per file, for robustness (non-PNG inputs etc.)
        return np.stack([
            np.atleast_3d(decode_png(p, size_hw, channels, bilinear))
            for p in paths])
    return out


def encode_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [h, w] (gray) or [h, w, 3] (RGB) as PNG."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    c = 1 if img.ndim == 2 else img.shape[2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if lib is not None and lib.mspl_encode_png_file(
            path.encode(), _u8(img), img.shape[0], img.shape[1], c) == 0:
        return
    from PIL import Image

    Image.fromarray(img).save(path)


def _pil_decode(path, size_hw, channels, bilinear):
    from PIL import Image

    h, w = size_hw
    with Image.open(path) as im:
        im = im.convert("RGB" if channels == 3 else "L")
        if im.size != (w, h):
            im = im.resize((w, h),
                           Image.BILINEAR if bilinear else Image.NEAREST)
        return np.asarray(im, np.uint8)
