"""NetCDF → zarr ensemble ingestion.

Reference parity (create_zarr_archive.py:28-93): scan ``data_path`` for ICON
run folders ``atmcirc-straka_93_*``, match per-member NetCDF files against
``filename_regex`` (group 1 = member id), tag the member coordinate from the
filename, and append each member's field along the ``member`` dimension of a
consolidated zarr archive chunked ``{time: 32, member: all, spatial: all}``
with zlib level-1 compression.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from gwen.config import DataConfig
from gwen.data import netcdf, zarrstore
from gwen.logging_utils import get_logger

log = get_logger()


def find_member_files(
    data_path: str | Path,
    filename_regex: str,
    folder_glob: str = "*",
) -> list[tuple[str, Path]]:
    """(member_id, file) pairs discovered under ICON run folders."""
    pattern = re.compile(filename_regex)
    out: list[tuple[str, Path]] = []
    root = Path(data_path)
    if not root.exists():
        raise FileNotFoundError(f"data_path not found: {root}")
    folders = sorted(p for p in root.glob(folder_glob) if p.is_dir()) or [root]
    for folder in folders:
        for f in sorted(folder.iterdir()):
            m = pattern.match(f.name)
            if m:
                member_id = m.group(1) if m.groups() else f.stem
                out.append((member_id, f))
    return out


def ingest(config: DataConfig, folder_glob: str = "atmcirc-straka_93_*") -> zarrstore.ZarrArray:
    """Build the consolidated ``{zarr_path}`` archive from raw NetCDF members."""
    files = find_member_files(config.data_path, config.filename_regex, folder_glob)
    if not files:
        raise FileNotFoundError(
            f"no member files matching {config.filename_regex!r} under {config.data_path}"
        )
    archive = None
    member_ids: list[str] = []
    for member_id, path in files:
        var = netcdf.read_variable(path, config.variable)
        values = np.asarray(var.values, np.float32)
        dims = list(var.dims)
        if "member" in dims:
            ax = dims.index("member")
            if values.shape[ax] != 1:
                raise ValueError(f"{path} has {values.shape[ax]} members; expected 1")
            values = np.squeeze(values, axis=ax)
            dims.pop(ax)
        # Normalize to (time, member, *spatial)
        if dims and dims[0] != "time":
            raise ValueError(f"{path}: expected leading time dim, got {dims}")
        values = np.expand_dims(values, 1)
        out_dims = [dims[0], "member"] + dims[1:]
        if archive is None:
            shape = list(values.shape)
            shape[1] = 0
            chunks = list(values.shape)
            chunks[0] = min(config.time_chunk, values.shape[0])
            chunks[1] = 1
            archive = zarrstore.create(
                config.zarr_path,
                shape=shape,
                dims=out_dims,
                chunks=chunks,
                compression_level=config.zlib_compression_level,
                meta={"variable": config.variable, "members": []},
            )
        archive.append(values, dim="member")
        member_ids.append(member_id)
        log.info("ingested member %s from %s", member_id, path.name)
    assert archive is not None
    archive.meta["members"] = member_ids
    archive.save_meta()
    return archive
