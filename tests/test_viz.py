"""Visualization tests (reference create_gif.py / utils.py:214-352 parity)."""

import numpy as np
import pytest

from gwen import viz

pytest.importorskip("matplotlib")
pytest.importorskip("PIL")


def test_get_member_name():
    # Units + ".0" stripping match the reference (create_gif.py:141-162).
    assert (
        viz.get_member_name("-10.0_3000.0_2000.0")
        == "Temp: -10 °C; Height: 3000 m; Width: 2000 m"
    )


def test_create_animation_gif(tmp_path):
    data = np.random.default_rng(0).normal(size=(3, 6, 10)).astype(np.float32)
    path = viz.create_animation(data, "-10.0_3000.0_2000.0", tmp_path, label="GNN")
    assert path.exists()
    from PIL import Image

    im = Image.open(path)
    assert im.n_frames == 3


def test_animate_predictions(tmp_path):
    preds = np.random.default_rng(1).normal(size=(2, 2, 4, 5)).astype(np.float32)
    paths = viz.animate_predictions(preds, ["a_1_2", "b_3_4"], tmp_path)
    assert len(paths) == 2
    assert all(p.exists() for p in paths)


def test_constant_field_clim(tmp_path):
    # Constant data must not crash the percentile clim (lo == hi guard).
    data = np.ones((2, 3, 3), np.float32)
    path = viz.create_animation(data, "c_0_0", tmp_path)
    assert path.exists()
