"""CLI end-to-end tests on CPU: ingest → preprocess → train-gnn → gif.

Reference analog: the full train_gnn.py orchestration (SURVEY §3.1), driven
through the argparse surface.
"""

import json

import numpy as np
import pytest

from gwen.cli.main import main as cli
from gwen.data import netcdf

T, H, C = 8, 4, 6


@pytest.fixture
def workdir(tmp_path):
    for i in range(4):
        mid = f"{-10 - i}.0_3000.0_2000.0"
        folder = tmp_path / f"atmcirc-straka_93_{mid}"
        folder.mkdir()
        t = np.arange(T)[:, None, None]
        h = np.arange(H)[None, :, None]
        c = np.arange(C)[None, None, :]
        field = (
            280 + 5 * np.sin(0.3 * t + 0.2 * i) * np.cos(0.5 * h + 0.1 * c)
        ).astype(np.float32)
        netcdf.write_netcdf_like(
            folder / f"atmcirc-straka_93_{mid}_DOM01_ML_20080801T000000Z.nc",
            {"theta_v": (("time", "height", "ncells"), field)},
        )
    cfg = {
        "batch_size": 2,
        "coarsen": 1,
        "data_path": str(tmp_path),
        "data_test": str(tmp_path / "test.zarr"),
        "data_train": str(tmp_path / "train.zarr"),
        "epochs": 2,
        "filename_regex": r"atmcirc-straka_93_(.+)_DOM01_ML_.*\.nc",
        "hidden_feats": 16,
        "lr": 1e-4,
        "mask_threshold": 0.0,
        "member_split": 3,
        "retrain": True,
        "seed": 42,
        "simplify": False,
        "zarr_path": str(tmp_path / "combined.zarr"),
        "zlib_compression_level": 1,
    }
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return tmp_path, cfg_path


def test_cli_full_pipeline(workdir, tmp_path, capsys):
    wd, cfg = workdir

    assert cli(["ingest", "--config", str(cfg)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [T, 4, H, C]

    assert cli(["preprocess", "--config", str(cfg)]) == 0
    capsys.readouterr()

    assert (
        cli([
            "train-gnn", "--config", str(cfg),
            "--out-dir", str(wd / "output"),
            f"run.registry_root={wd / 'runs'}",
            "data.boundary_cells=0",
        ])
        == 0
    )
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["test_loss"])
    assert out["animations"]

    assert cli(["gif", "--input", str(wd / "test.zarr"), "--out", str(wd / "gifs"),
                "--member", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["gifs"]) == 1


def test_cli_gif_interactive_fallback(workdir, capsys, monkeypatch):
    """Bare `gif` invocation prompts for its inputs (reference parity:
    create_gif.py:305-315 falls back to input() without argv)."""
    wd, cfg = workdir
    cli(["ingest", "--config", str(cfg)])
    cli(["preprocess", "--config", str(cfg)])
    capsys.readouterr()
    answers = iter([str(wd / "test.zarr"), "", str(wd / "gifs_i")])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli(["gif", "--member", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["gifs"]) == 1


def test_cli_train_cnn(workdir, capsys):
    wd, cfg = workdir
    cli(["ingest", "--config", str(cfg)])
    cli(["preprocess", "--config", str(cfg)])
    capsys.readouterr()
    assert (
        cli([
            "train-cnn", "--config", str(cfg), "--no-animate",
            f"run.registry_root={wd / 'runs'}",
            "data.boundary_cells=0", "unet.hidden=4", "unet.depth=2",
        ])
        == 0
    )
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["test_loss"])


def test_cli_mesh_data_roundtrip(tmp_path, capsys):
    """make-mesh-data → train-mesh --data on CPU."""
    assert cli(["make-mesh-data", "--out", str(tmp_path / "m.zarr"),
                "--members", "3", "--steps", "6", "graph.refine=2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fields"][1] == 3

    assert cli(["train-mesh", "--data", str(tmp_path / "m.zarr"),
                "model.latent_size=8", "model.process_steps=1",
                "train.epochs=1", "train.batch_size=4", "train.lr=1e-3",
                f"run.registry_root={tmp_path / 'runs'}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_train_loss"])
    assert out["nodes"] == 162  # 10*4^2+2


def test_cli_train_mesh_attention(tmp_path, capsys):
    """train-mesh with the windowed graph-attention processor (CPU)."""
    assert cli(["make-mesh-data", "--out", str(tmp_path / "m.zarr"),
                "--members", "2", "--steps", "4", "graph.refine=2"]) == 0
    capsys.readouterr()
    assert cli(["train-mesh", "--data", str(tmp_path / "m.zarr"),
                "model.latent_size=8", "model.processor=attention",
                "model.attn_heads=2", "model.process_steps=1",
                "mesh.diag_window=128",
                "train.epochs=1", "train.batch_size=2", "train.lr=1e-3",
                f"run.registry_root={tmp_path / 'runs'}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best_train_loss"])
