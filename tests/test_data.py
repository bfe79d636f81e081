"""Data layer tests: NetCDF reader, zarr archive, ingest, preprocess, datasets.

Uses a synthetic ICON-like ensemble fixture (SURVEY §4: keep the tiny-fixture
idea, but generate it instead of shipping binary data).
"""

import numpy as np
import pytest

from gwen.config import DataConfig
from gwen.data import netcdf, zarrstore
from gwen.data.dataset import ConvEnsembleDataset, MemberGraphDataset, load_data
from gwen.data.ingest import find_member_files, ingest
from gwen.data.preprocess import (
    coarsen_block_mean,
    compute_scaling,
    interpolate_nans_time,
    preprocess,
    split_time_indices,
)

T, H, C = 10, 4, 6  # time, height, ncells
MEMBERS = ["-10.0_3000.0_2000.0", "-12.0_3000.0_2000.0", "-10.0_2500.0_1000.0"]


def _straka_like_field(member_idx: int) -> np.ndarray:
    """Smooth deterministic pseudo-density-current field per member."""
    t = np.arange(T)[:, None, None]
    h = np.arange(H)[None, :, None]
    c = np.arange(C)[None, None, :]
    return (
        np.sin(0.3 * t + 0.1 * member_idx)
        * np.cos(0.5 * h)
        * np.exp(-0.1 * (c - C / 2) ** 2)
    ).astype(np.float32)


@pytest.fixture
def raw_dir(tmp_path):
    for i, mid in enumerate(MEMBERS):
        folder = tmp_path / f"atmcirc-straka_93_{mid}"
        folder.mkdir()
        netcdf.write_netcdf_like(
            folder / f"atmcirc-straka_93_{mid}_DOM01_ML_20080801T000000Z.nc",
            {"theta_v": (("time", "height", "ncells"), _straka_like_field(i))},
        )
    return tmp_path


@pytest.fixture
def data_cfg(raw_dir, tmp_path):
    return DataConfig(
        data_path=str(raw_dir),
        zarr_path=str(tmp_path / "combined.zarr"),
        data_train=str(tmp_path / "train.zarr"),
        data_test=str(tmp_path / "test.zarr"),
        scaling_path=str(tmp_path / "scaling.json"),
        boundary_cells=0,
        time_chunk=4,
    )


def test_netcdf_roundtrip(tmp_path):
    values = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    p = tmp_path / "f.nc"
    netcdf.write_netcdf_like(p, {"theta_v": (("time", "height", "ncells"), values)})
    var = netcdf.read_variable(p, "theta_v")
    assert var.dims == ("time", "height", "ncells")
    np.testing.assert_array_equal(var.values, values)
    assert "theta_v" in netcdf.list_variables(p)


def test_zarr_append_and_read(tmp_path):
    arr = zarrstore.create(
        tmp_path / "a.zarr", shape=(5, 0, 3), dims=("time", "member", "cell"),
        chunks=(5, 1, 3),
    )
    a = np.ones((5, 3), np.float32)
    arr.append(a, dim="member")
    arr.append(2 * a, dim="member")
    out = zarrstore.open_array(tmp_path / "a.zarr")
    assert out.shape == (5, 2, 3)
    assert out.dims == ("time", "member", "cell")
    np.testing.assert_array_equal(out[:, 1, :], 2 * a)


def test_find_member_files(raw_dir):
    files = find_member_files(
        raw_dir, r"atmcirc-straka_93_(.+)_DOM01_ML_.*\.nc", "atmcirc-straka_93_*"
    )
    assert len(files) == 3
    assert {m for m, _ in files} == set(MEMBERS)


def test_ingest_and_preprocess(data_cfg):
    archive = ingest(data_cfg)
    assert archive.shape == (T, 3, H, C)
    assert archive.dims == ("time", "member", "height", "ncells")
    assert archive.meta["members"] == sorted(MEMBERS) or set(
        archive.meta["members"]
    ) == set(MEMBERS)

    preprocess(data_cfg)
    train, test, meta = load_data(data_cfg)
    assert train.shape[0] + test.shape[0] == T
    assert train.shape[1:] == (3, H, C)
    # Normalized: overall train stats near (0, 1).
    assert abs(train.mean()) < 0.2
    assert 0.5 < train.std() < 1.5
    assert "scaling" in meta


def test_split_deterministic():
    a1, b1 = split_time_indices(10, 0.7)
    a2, b2 = split_time_indices(10, 0.7)
    np.testing.assert_array_equal(a1, a2)
    assert len(a1) == 7 and len(b1) == 3
    assert set(a1) | set(b1) == set(range(10))


def test_interpolate_nans():
    x = np.array([[0.0], [np.nan], [2.0]], np.float32)
    out = interpolate_nans_time(x)
    np.testing.assert_allclose(out[1, 0], 1.0)


def test_scaling_methods():
    data = np.random.default_rng(0).normal(3.0, 2.0, size=1000)
    s = compute_scaling(data, "mean-std")
    assert abs(s["center"] - 3.0) < 0.3 and abs(s["scale"] - 2.0) < 0.3
    s2 = compute_scaling(data, "median-mad")
    assert abs(s2["center"] - 3.0) < 0.3


def test_coarsen_block_mean():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    out = coarsen_block_mean(x, 2, axes=(2, 3))
    assert out.shape == (1, 1, 2, 2)
    np.testing.assert_allclose(out[0, 0, 0, 0], np.mean([0, 1, 4, 5]))


def test_member_graph_dataset():
    data = np.random.default_rng(0).normal(size=(6, 5, 3, 4)).astype(np.float32)
    ds = MemberGraphDataset(data=data, member_split=3, seed=1)
    assert len(ds) == 6
    assert ds.num_nodes == 5 and ds.num_features == 12
    assert ds.target_mask.sum() == 2
    batches = list(ds.batches(batch_size=2))
    assert len(batches) == 3
    x, mask = batches[0]
    assert x.shape == (2, 5, 12)
    assert mask.shape == (5,)


def test_member_graph_dataset_mask_inputs():
    data = np.ones((2, 4, 2, 2), np.float32)
    ds = MemberGraphDataset(data=data, member_split=2, seed=0, mask_inputs=True)
    x = ds.features(0)
    assert np.all(x[ds.target_mask] == 0)
    assert np.all(x[~ds.target_mask] == 1)


def test_conv_dataset():
    data = np.random.default_rng(0).normal(size=(5, 6, 3, 4)).astype(np.float32)
    ds = ConvEnsembleDataset(data=data, member_split=4, seed=1)
    x, y = ds[0]
    assert x.shape == (4, 3, 4) and y.shape == (2, 3, 4)
    xb, yb = next(iter(ds.batches(2)))
    assert xb.shape == (2, 4, 3, 4) and yb.shape == (2, 2, 3, 4)


def test_simplify_mode():
    data = np.zeros((3, 8, 2, 2), np.float32)
    ds = MemberGraphDataset(data=data, member_split=6, seed=0, simplify=True)
    assert len(ds.input_indices) == 1 and len(ds.target_indices) == 1


def test_multihost_helpers_single_process(tmp_path):
    """Single-process degradation of the multi-host shard helpers."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gwen.data import multihost, zarrstore
    from gwen.train import make_mesh

    arr = zarrstore.create(
        tmp_path / "mh.zarr", shape=(4, 6, 3), dims=("time", "member", "cell"),
        chunks=(4, 2, 3),
    )
    data = np.arange(4 * 6 * 3, dtype=np.float32).reshape(4, 6, 3)
    arr.write((slice(None), slice(None), slice(None)), data)

    sl = multihost.process_slice(6)
    assert sl == slice(0, 6)  # single process owns everything
    shard = multihost.load_member_shard(zarrstore.open_array(tmp_path / "mh.zarr"))
    np.testing.assert_array_equal(shard, data)

    ndev = len(jax.devices())
    mesh = make_mesh(data=ndev, graph=1)
    batch = np.repeat(data[:1], ndev * 2, axis=0)  # divisible by the data axis
    garr = multihost.global_sharded_array(batch, mesh, P("data"))
    assert garr.shape == (ndev * 2, 6, 3)
    np.testing.assert_array_equal(multihost.all_gather_from_hosts(data), data)


def test_member_graph_node_batching():
    """NeighborLoader-parity node batching (models_gnn.py:351-356)."""
    data = np.random.default_rng(0).normal(size=(4, 10, 2, 3)).astype(np.float32)
    ds = MemberGraphDataset(data=data, member_split=6, seed=1)
    for x, mask in ds.batches(2, node_batch_size=3, seed=0):
        assert mask.sum() >= 1  # at least one target node kept
        assert mask.sum() <= 3 + 1
        assert (mask & ~ds.target_mask).sum() == 0  # subset of targets


def test_meshstore_roundtrip(tmp_path):
    from gwen.data.meshstore import load_mesh_dataset, save_mesh_dataset
    from gwen.data.synthetic import mesh_ensemble_dataset

    fields, verts, s, r = mesh_ensemble_dataset(levels=2, members=2, steps=4)
    p = save_mesh_dataset(tmp_path / "mesh.zarr", fields, s, r, verts)
    f2, s2, r2, v2, meta = load_mesh_dataset(p)
    np.testing.assert_allclose(f2, fields, rtol=1e-6)
    np.testing.assert_array_equal(s2, s)
    assert meta["kind"] == "mesh-ensemble"


def test_mask_inputs_batches_carry_unmasked_target():
    """Regression: mask_inputs must not turn the loss into predict-zeros."""
    data = np.random.default_rng(3).normal(size=(4, 5, 2, 3)).astype(np.float32)
    ds = MemberGraphDataset(data=data, member_split=3, seed=0, mask_inputs=True)
    batch = next(iter(ds.batches(2)))
    assert len(batch) == 3
    x, mask, target = batch
    assert np.all(x[:, ds.target_mask] == 0)  # input masked
    assert not np.all(target[:, ds.target_mask] == 0)  # truth preserved
