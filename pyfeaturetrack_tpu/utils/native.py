"""Loader for the native (C++) host-side components.

The compute path is JAX/XLA/Pallas on the device; the runtime pieces that are
inherently host-sequential (greedy min-distance suppression) are C++,
compiled on demand with the system toolchain and loaded via ctypes
(no pybind11 in this environment). Falls back cleanly when no compiler
is available — callers must check ``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent.parent / "native"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build"
_LIB_NAME = "libpft_native.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> Path | None:
    _BUILD.mkdir(exist_ok=True)
    out = _BUILD / _LIB_NAME
    srcs = sorted(_SRC.glob("*.cpp"))
    if not srcs:
        return None
    if out.exists() and out.stat().st_mtime >= max(s.stat().st_mtime
                                                   for s in srcs):
        return out
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", str(out)]
            + [str(s) for s in srcs],
            check=True, capture_output=True, timeout=120)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PFT_NO_NATIVE"):
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        fn = lib.pft_enforce_min_distance
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        # PNM codec entry points bind through raw CFUNCTYPE prototypes:
        # ndpointer argtype validation costs ~10 us/call, which matters
        # at serving decode rates (the header parse itself is ~0.1 us)
        global _pnm_hdr, _pnm_asc
        _pnm_hdr = ctypes.CFUNCTYPE(
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64))(("pft_pnm_parse_header", lib))
        _pnm_asc = ctypes.CFUNCTYPE(
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)(
            ("pft_pnm_decode_ascii", lib))
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def enforce_min_distance(xs: np.ndarray, ys: np.ndarray, vals: np.ndarray,
                         order: np.ndarray, feats: np.ndarray,
                         shape: tuple[int, int], mindist: int,
                         min_eigenvalue: int, overwrite_all: bool
                         ) -> np.ndarray:
    """Native greedy suppression. ``feats`` (N,3) float64 is copied;
    returns the filled copy. Semantics identical to the NumPy path in
    ops/select.py (tested equal)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    nrows, ncols = shape
    out = np.ascontiguousarray(feats, dtype=np.float64).copy()
    fmap = np.zeros(nrows * ncols, np.uint8)
    lib.pft_enforce_min_distance(
        np.ascontiguousarray(xs, np.int64),
        np.ascontiguousarray(ys, np.int64),
        np.ascontiguousarray(vals, np.int64),
        np.ascontiguousarray(order, np.int64),
        np.int64(order.shape[0]),
        out, np.int64(out.shape[0]),
        np.int64(nrows), np.int64(ncols),
        np.int64(mindist), np.int64(min_eigenvalue),
        1 if overwrite_all else 0,
        fmap)
    return out


# ---------------------------------------------------------------------------
# PNM codec (native/pnm_codec.cpp) — see utils/io.py for the public API
# ---------------------------------------------------------------------------

PNM_TRUNCATED = -1
PNM_BAD_MAGIC = -2
PNM_BAD_TOKEN = -3

_pnm_hdr = None
_pnm_asc = None
_Out5 = ctypes.c_int64 * 5


def pnm_parse_header(data: bytes):
    """Parse a PNM header from the file bytes.

    Returns (rc, fmt, width, height, maxval, data_offset): rc == 0 on
    success, else one of the PNM_* error codes (caller maps to KLTError
    so the message can carry the path)."""
    assert _load() is not None, "native library unavailable"
    out = _Out5()
    rc = _pnm_hdr(data, len(data), out)
    return rc, out[0], out[1], out[2], out[3], out[4]


def pnm_decode_ascii(payload: bytes, npix: int):
    """Decode ascii (P2) grey values. Returns (rc, pixels): rc is the
    number of values decoded (< npix means truncated) or PNM_BAD_TOKEN;
    pixels is a uint8 array of the decoded prefix."""
    assert _load() is not None, "native library unavailable"
    pix = np.zeros(int(npix), np.uint8)
    rc = _pnm_asc(payload, len(payload),
                  pix.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  int(npix))
    return int(rc), pix
