"""ctypes bindings for the native graph-preprocessing library.

Builds ``graphcore.cpp`` with g++ on first use (cached as a shared object
next to the source, keyed by source hash); every entry point has a
pure-Python fallback in ``gwen.graph.reorder``, so the framework works
without a toolchain — the native path is a host-side speedup (minutes →
sub-second RCM at ICON-mesh scale).
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "graphcore.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[ctypes.CDLL]:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    out = _SRC.parent / f"_graphcore_{tag}.so"
    if not out.exists():
        for stale in _SRC.parent.glob("_graphcore_*.so"):
            stale.unlink(missing_ok=True)
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            str(_SRC), "-o", str(out),
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.gwen_rcm_order.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.gwen_rcm_order.restype = ctypes.c_int
    lib.gwen_bandwidth.argtypes = [ctypes.c_int64, i64p, i64p]
    lib.gwen_bandwidth.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build()
        except Exception:
            _LIB = None
    return _LIB


def rcm_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int) -> Optional[np.ndarray]:
    """Native RCM; returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(senders, np.int64)
    r = np.ascontiguousarray(receivers, np.int64)
    out = np.empty(num_nodes, np.int64)
    rc = lib.gwen_rcm_order(num_nodes, len(s), s, r, out)
    if rc != 0:
        raise ValueError("native rcm_order: edge index out of range")
    return out


def bandwidth(senders: np.ndarray, receivers: np.ndarray) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(senders, np.int64)
    r = np.ascontiguousarray(receivers, np.int64)
    return int(lib.gwen_bandwidth(len(s), s, r))
