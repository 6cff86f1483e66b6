"""ctypes loader for the first-party native (C++) runtime library.

Builds ``libguidemaker_native.so`` from source on first use if a compiler
is available (``make -C guidemaker_tpu/native`` builds it explicitly); the
library is never committed, since ``-march=native`` ties it to the
building host.  All call sites
degrade gracefully to the numpy/JAX paths when the library is absent, so
the package works on systems without a toolchain.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libguidemaker_native.so")
_SRC = os.path.join(_DIR, "guidemaker_native.cpp")

_lib = None
_load_attempted = False


def _build() -> bool:
    # build beside the target and rename into place: concurrent first
    # uses (test workers, threads) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native library build failed (%r); using pure paths", e)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        logger.info("could not load native library: %r", e)
        return None
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.gm_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8]
    lib.gm_scan_pam.restype = ctypes.c_int64
    lib.gm_scan_pam.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int32,
                                i64, ctypes.c_int64]
    lib.gm_hamming_topk.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, i32, i32]
    lib.gm_levenshtein.restype = ctypes.c_int32
    lib.gm_levenshtein.argtypes = [u8, ctypes.c_int32, u8, ctypes.c_int32]
    lib.gm_leven_topk.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, i32, i32]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode(seq: str) -> np.ndarray:
    """Strict 2-bit encoding via the native codec."""
    lib = load()
    raw = seq.encode("ascii")
    out = np.empty(len(raw), dtype=np.uint8)
    lib.gm_encode(raw, len(raw), _u8ptr(out))
    return out


def scan_pam(codes: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Overlapped degenerate-PAM scan; returns match start positions."""
    lib = load()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    cap = codes.shape[0]
    out = np.empty(cap, dtype=np.int64)
    n = lib.gm_scan_pam(_u8ptr(codes), codes.shape[0], _u8ptr(masks),
                        masks.shape[0],
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        cap)
    return out[:n].copy()


def hamming_topk(q_codes: np.ndarray, db_codes: np.ndarray, k: int,
                 n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN via packed XOR/popcount; same contract as the JAX engine.

    Precondition: all codes < 4 (strict ACGT).  The 2-bit packing
    aliases INVALID=4 to 'A'; the KnnIndex driver routes ambiguous-base
    guides to the JAX paths, where a one-hot zero row makes N match
    nothing.
    """
    lib = load()
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    db = np.ascontiguousarray(db_codes, dtype=np.uint8)
    nq, L = q.shape
    nd = db.shape[0]
    k_eff = min(k, nd)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    dist = np.empty((nq, k_eff), dtype=np.int32)
    idx = np.empty((nq, k_eff), dtype=np.int32)
    lib.gm_hamming_topk(
        _u8ptr(db), nd, _u8ptr(q), nq, L, k_eff, n_threads,
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if k_eff < k:
        pad = np.full((nq, k - k_eff), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


def leven_topk(q_codes: np.ndarray, db_codes: np.ndarray, k: int,
               n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Levenshtein k-NN via the bit-parallel Myers kernel.

    Same contract and tie-break ordering (distance asc, db index asc) as
    :func:`hamming_topk` and the JAX ``knn.leven.leven_topk`` engine.
    Requires guide length <= 32 (the DP column packs into one uint32)
    and all codes < 4 (the Peq masks alias INVALID=4 to 'A'; see
    :func:`hamming_topk`); the driver gates both.
    """
    lib = load()
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    db = np.ascontiguousarray(db_codes, dtype=np.uint8)
    nq, L = q.shape
    if L > 32:
        raise ValueError(f"native leven_topk requires L <= 32, got {L}")
    nd = db.shape[0]
    k_eff = min(k, nd)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    dist = np.empty((nq, k_eff), dtype=np.int32)
    idx = np.empty((nq, k_eff), dtype=np.int32)
    lib.gm_leven_topk(
        _u8ptr(db), nd, _u8ptr(q), nq, L, k_eff, n_threads,
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if k_eff < k:
        pad = np.full((nq, k - k_eff), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


def levenshtein(a: np.ndarray, b: np.ndarray) -> int:
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    return int(lib.gm_levenshtein(_u8ptr(a), a.shape[0], _u8ptr(b), b.shape[0]))
