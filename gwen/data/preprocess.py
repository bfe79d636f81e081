"""Preprocessing: crop, de-NaN, split, normalize, coarsen, write train/test.

Reference parity (preprocess_data.py — a module-level script there; proper
functions here):

* boundary-cell crop: keep ``ncells >= boundary_cells`` index
  (preprocess_data.py:122-126),
* linear interpolation of NaNs along time (:135-137),
* 70/30 time-shuffled train/test split, seed from config (:26-66, seed 42),
* mean/std or median/MAD normalization with persisted scale factors
  (:69-111; ``data/scaling.txt`` → ``scaling.json`` here),
* output stores chunked ``{time: 32, member: all, spatial: all}`` (:161-187),
* spatial coarsening by block mean (utils.py:355-379 ``downscale_data``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from gwen.config import DataConfig
from gwen.data import zarrstore
from gwen.logging_utils import get_logger

log = get_logger()


def interpolate_nans_time(values: np.ndarray) -> np.ndarray:
    """Linearly interpolate NaNs along axis 0 (time), in place-safe copy."""
    if not np.isnan(values).any():
        return values
    out = values.copy()
    t = np.arange(out.shape[0], dtype=np.float64)
    flat = out.reshape(out.shape[0], -1)
    bad_cols = np.nonzero(np.isnan(flat).any(axis=0))[0]
    for c in bad_cols:
        col = flat[:, c]
        nan = np.isnan(col)
        if nan.all():
            flat[:, c] = 0.0
        else:
            col[nan] = np.interp(t[nan], t[~nan], col[~nan])
    return out


def split_time_indices(
    num_times: int, train_fraction: float = 0.7, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Shuffled time-index split (preprocess_data.py:26-66: 70/30, seed 42)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_times)
    n_train = int(round(num_times * train_fraction))
    return np.sort(idx[:n_train]), np.sort(idx[n_train:])


def compute_scaling(values: np.ndarray, method: str = "mean-std") -> dict:
    """Normalization constants (preprocess_data.py:69-111)."""
    if method == "mean-std":
        return {
            "method": method,
            "center": float(np.mean(values)),
            "scale": float(np.std(values)) or 1.0,
        }
    if method == "median-mad":
        med = float(np.median(values))
        mad = float(np.median(np.abs(values - med))) or 1.0
        return {"method": method, "center": med, "scale": mad}
    raise ValueError(f"unknown normalization {method!r}")


def apply_scaling(values: np.ndarray, scaling: dict) -> np.ndarray:
    return (values - scaling["center"]) / scaling["scale"]


def invert_scaling(values: np.ndarray, scaling: dict) -> np.ndarray:
    return values * scaling["scale"] + scaling["center"]


def coarsen_block_mean(values: np.ndarray, factor: int, axes: tuple[int, ...]) -> np.ndarray:
    """Block-mean downscaling over ``axes`` (utils.py:355-379), truncating
    remainders so every block is full."""
    if factor <= 1:
        return values
    out = values
    for ax in axes:
        n = out.shape[ax]
        keep = (n // factor) * factor
        sl = [slice(None)] * out.ndim
        sl[ax] = slice(0, keep)
        out = out[tuple(sl)]
        new_shape = (
            out.shape[:ax] + (keep // factor, factor) + out.shape[ax + 1 :]
        )
        out = out.reshape(new_shape).mean(axis=ax + 1)
    return out


def preprocess(config: DataConfig) -> tuple[Path, Path]:
    """Full pipeline: archive → cropped/normalized train+test zarr stores."""
    archive = zarrstore.open_array(config.zarr_path)
    values = archive.read()  # (time, member, *spatial)
    dims = list(archive.dims)

    # Boundary-cell crop on the trailing cell axis (preprocess_data.py:124).
    if "ncells" in dims and config.boundary_cells > 0:
        ax = dims.index("ncells")
        if values.shape[ax] > config.boundary_cells:
            sl = [slice(None)] * values.ndim
            sl[ax] = slice(config.boundary_cells, None)
            values = values[tuple(sl)]

    values = interpolate_nans_time(values)

    train_idx, test_idx = split_time_indices(
        values.shape[0], config.train_fraction
    )
    scaling = compute_scaling(values[train_idx], config.normalization)
    Path(config.scaling_path).parent.mkdir(parents=True, exist_ok=True)
    Path(config.scaling_path).write_text(json.dumps(scaling, indent=2))
    values = apply_scaling(values, scaling).astype(np.float32)

    def _write(path: str, idx: np.ndarray) -> Path:
        subset = values[idx]
        chunks = list(subset.shape)
        chunks[0] = min(config.time_chunk, subset.shape[0])
        arr = zarrstore.create(
            path,
            shape=subset.shape,
            dims=dims,
            chunks=chunks,
            compression_level=config.zlib_compression_level,
            meta={"scaling": scaling, "time_indices": idx.tolist(), **archive.meta},
        )
        arr.write(tuple(slice(None) for _ in subset.shape), subset)
        return Path(path)

    train_path = _write(config.data_train, train_idx)
    test_path = _write(config.data_test, test_idx)
    log.info(
        "preprocess: %d train / %d test steps, scaling=%s",
        len(train_idx), len(test_idx), scaling,
    )
    return train_path, test_path
