"""Lists of arrays in ``.npz`` files, numpy extension dtypes included.

``np.savez`` stores ml_dtypes extension dtypes (bfloat16, fp8) as raw void
(``|V2``), which reloads without its dtype. :func:`save_arrays` stores their
bit pattern as an unsigned int of the same width, with every array's dtype
name beside the arrays; :func:`load_arrays` views each back. This is the one
array format of the serving artifacts, the registry's params and the step
checkpoints.
"""

from __future__ import annotations

import json

import numpy as np

_BIT_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_DTYPES = "dtypes"


def _storable(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "V":  # extension dtype (not a builtin numpy one)
        return np.ascontiguousarray(a).view(_BIT_VIEW[a.dtype.itemsize])
    return a


def _as_dtype(a: np.ndarray, name: str) -> np.ndarray:
    if a.dtype.name == name:
        return a
    import ml_dtypes  # noqa: F401  (registers bfloat16 et al.)

    return np.ascontiguousarray(a).view(np.dtype(name))


def save_arrays(path, arrays: list) -> None:
    """Write ``arrays`` (numpy arrays) to the ``.npz`` file ``path``."""
    arrays = [np.asarray(a) for a in arrays]
    stored = {f"a{i}": _storable(a) for i, a in enumerate(arrays)}
    stored[_DTYPES] = np.asarray(json.dumps([a.dtype.name for a in arrays]))
    np.savez(path, **stored)


def load_arrays(path) -> list[np.ndarray]:
    """Inverse of :func:`save_arrays`."""
    with np.load(path) as z:
        names = json.loads(str(z[_DTYPES]))
        arrays = [z[f"a{i}"] for i in range(len(names))]
    return [_as_dtype(a, name) for a, name in zip(arrays, names)]
