"""Streaming (lazy) epoch iterators: equivalence with eager loading and the
host-memory guarantee — only per-time-step slabs are ever read from the
store (round-1 verdict #4; reference analog: dask laziness, utils.py:478-520).
"""

import numpy as np
import pytest

from gwen.config import DataConfig
from gwen.data import zarrstore
from gwen.data.dataset import (
    ConvEnsembleDataset,
    MemberGraphDataset,
    MeshEnsembleDataset,
    load_split,
)
from gwen.data.lazy import LazyField

pytest.importorskip("tensorstore")

T, M, H, C = 10, 5, 4, 6


@pytest.fixture()
def store(tmp_path):
    rng = np.random.default_rng(0)
    values = rng.normal(size=(T, M, H, C)).astype(np.float32)
    arr = zarrstore.create(
        tmp_path / "train.zarr", shape=values.shape,
        dims=("time", "member", "height", "ncells"),
        chunks=(2, M, H, C),
    )
    arr.write(tuple(slice(None) for _ in values.shape), values)
    return tmp_path / "train.zarr", values


def _cfg(path):
    return DataConfig(data_train=str(path), data_test=str(path), lazy=True)


def test_lazy_equals_eager_member_graph(store):
    path, values = store
    lazy, _ = load_split(_cfg(path), "train")
    assert isinstance(lazy, LazyField)
    assert lazy.shape == values.shape

    ds_lazy = MemberGraphDataset(data=lazy, member_split=3, seed=1)
    ds_eager = MemberGraphDataset(data=values, member_split=3, seed=1)
    for (xl, ml), (xe, me) in zip(ds_lazy.batches(2, shuffle=True, seed=3),
                                  ds_eager.batches(2, shuffle=True, seed=3)):
        np.testing.assert_array_equal(xl, xe)
        np.testing.assert_array_equal(ml, me)


def test_lazy_equals_eager_conv(store):
    path, values = store
    lazy, _ = load_split(_cfg(path), "train")
    ds_lazy = ConvEnsembleDataset(data=lazy, member_split=3, seed=1)
    ds_eager = ConvEnsembleDataset(data=values, member_split=3, seed=1)
    for (xl, yl), (xe, ye) in zip(ds_lazy.batches(3), ds_eager.batches(3)):
        np.testing.assert_array_equal(xl, xe)
        np.testing.assert_array_equal(yl, ye)


def test_lazy_never_materializes_archive(store, monkeypatch):
    """The memory guarantee: every store read is at most one time-step slab;
    a full epoch never calls a whole-array read."""
    path, values = store
    lazy, _ = load_split(_cfg(path), "train")

    step_elems = int(np.prod(values.shape[1:]))
    reads = []
    orig = zarrstore.ZarrArray.__getitem__

    def spy(self, idx):
        out = orig(self, idx)
        reads.append(out.size)
        return out

    monkeypatch.setattr(zarrstore.ZarrArray, "__getitem__", spy)
    monkeypatch.setattr(
        zarrstore.ZarrArray, "read",
        lambda self: pytest.fail("lazy path called a whole-array read()"),
    )

    ds = MemberGraphDataset(data=lazy, member_split=3, seed=1)
    count = 0
    for x, m in ds.batches(2, shuffle=True, seed=0):
        count += 1
        assert x.shape == (2, M, H * C)
    assert count == T // 2
    assert reads and max(reads) <= step_elems


def test_lazy_lru_caches_steps(store):
    path, values = store
    lazy, _ = load_split(_cfg(path), "train")
    lazy.step(0)
    lazy.step(0)
    assert len(lazy._cache) == 1
    for t in range(6):  # exceed cache_steps=4
        lazy.step(t)
    assert len(lazy._cache) == 4


def test_lazy_mesh_dataset(tmp_path):
    from gwen.data.meshstore import load_mesh_dataset, save_mesh_dataset

    rng = np.random.default_rng(1)
    fields = rng.normal(size=(6, 3, 20, 2)).astype(np.float32)
    s = np.array([0, 1, 2, 3])
    r = np.array([1, 2, 3, 4])
    save_mesh_dataset(tmp_path / "mesh.zarr", fields, s, r)

    lf, s2, r2, _, _ = load_mesh_dataset(tmp_path / "mesh.zarr", lazy=True)
    assert isinstance(lf, LazyField)
    np.testing.assert_array_equal(s2, s)

    ds_lazy = MeshEnsembleDataset(fields=lf)
    ds_eager = MeshEnsembleDataset(fields=fields)
    for (xl, yl), (xe, ye) in zip(ds_lazy.batches(4, shuffle=True, seed=2),
                                  ds_eager.batches(4, shuffle=True, seed=2)):
        np.testing.assert_array_equal(xl, xe)
        np.testing.assert_array_equal(yl, ye)
    for (xl, tl), (xe, te) in zip(
        ds_lazy.trajectory_batches(2, horizon=3, shuffle=True, seed=5),
        ds_eager.trajectory_batches(2, horizon=3, shuffle=True, seed=5),
    ):
        np.testing.assert_array_equal(xl, xe)
        np.testing.assert_array_equal(tl, te)

    # map() composes per-step transforms lazily (reorder / member select).
    sub = lf.map(lambda st: st[:-1])
    np.testing.assert_array_equal(sub[2], fields[2, :-1])
    assert sub.shape == (6, 2, 20, 2)


def test_train_mesh_cli_lazy_smoke(tmp_path):
    """End-to-end: train-mesh consumes a zarr store through the lazy path."""
    import jax

    from gwen.cli.train_mesh import main as mesh_main
    from gwen.config import GwenConfig
    from gwen.data.meshstore import save_mesh_dataset
    from gwen.data.synthetic import mesh_ensemble_dataset

    fields, verts, s, r = mesh_ensemble_dataset(levels=1, members=3, steps=6, seed=0)
    save_mesh_dataset(tmp_path / "mesh.zarr", fields, s, r, verts)

    cfg = GwenConfig()
    cfg.graph.refine = 1
    cfg.model.latent_size = 8
    cfg.model.process_steps = 1
    cfg.train.epochs = 1
    cfg.train.batch_size = 2
    cfg.train.calibrate_inflation = False
    cfg.train.calibrate_sigma = False
    cfg.data.lazy = True
    cfg.run.registry_root = str(tmp_path / "runs")
    out = mesh_main(cfg, data=str(tmp_path / "mesh.zarr"))
    assert np.isfinite(out["best_train_loss"])
    assert jax.default_backend() == "cpu"
