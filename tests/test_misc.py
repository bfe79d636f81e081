"""Logging, profiling, and version surface tests."""


import jax.numpy as jnp
import numpy as np
import pytest

import gwen
from gwen import profiling
from gwen.logging_utils import get_logger, setup_logger, suppress_warnings


def test_version_metadata():
    assert gwen.__version__
    assert gwen.__author__


def test_setup_logger_singleton(tmp_path):
    log1 = setup_logger(tmp_path / "log.txt", force=True)
    log2 = setup_logger(tmp_path / "other.txt")  # no force → same handlers
    assert log1 is log2
    assert log1.handlers  # process 0 gets handlers (loggers_configs.py:35-38)
    log1.info("hello")
    assert (tmp_path / "log.txt").exists()
    assert get_logger() is log1


def test_suppress_warnings_runs():
    suppress_warnings()  # must not raise


def test_profiling_timeit_and_steptimer():
    res = profiling.timeit(lambda x: x * 2, jnp.ones((8, 8)), iters=3)
    assert res["mean_s"] > 0

    timer = profiling.StepTimer(window=4, edges_per_step=100)
    for _ in range(3):
        with timer:
            _ = np.ones(10).sum()
    stats = timer.stats()
    assert stats["steps_per_s"] > 0
    assert stats["edges_per_s"] > 0


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, list) and stats
    assert "device" in stats[0]


# ---------------------------------------------------------- compile cache


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    import jax

    from gwen import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == tmp_path
    assert compile_cache.enable_compile_cache() == tmp_path
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path(monkeypatch):
    import jax

    from gwen import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = compile_cache.CHECKOUT / ".jax_cache"
    assert (compile_cache.CHECKOUT / "gwen" / "compile_cache.py").exists()
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == str(want)


# ------------------------------------------------------ installation / GPU


def _run(cmd, cwd):
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *cmd], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_path_imports_no_flax_or_orbax():
    from pathlib import Path

    code = ("import sys, gwen.cli.train_mesh, gwen.cli.export_cli, "
            "gwen.serve, gwen.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'flax', 'orbax'}))")
    res = _run(["-c", code], Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


_ALIAS_CHECKS = {
    # The former package name resolves to the same module objects, imports
    # neither flax nor orbax, and warns.
    "import": ["-c",
               "import warnings, sys\n"
               "with warnings.catch_warnings(record=True) as w:\n"
               "    warnings.simplefilter('always')\n"
               "    import gwen_tpu.cli.train_mesh, gwen_tpu.cli.export_cli\n"
               "    import gwen_tpu.serve\n"
               "import gwen.cli.train_mesh, gwen.serve\n"
               "from gwen_tpu.cli.main import main\n"
               "assert gwen_tpu.cli.train_mesh is gwen.cli.train_mesh\n"
               "assert gwen_tpu.serve is gwen.serve\n"
               "assert gwen.serve.__spec__.name == 'gwen.serve'\n"
               "assert main is gwen.cli.main.main\n"
               "assert gwen_tpu.GwenConfig is gwen.GwenConfig\n"
               "assert any(x.category is DeprecationWarning for x in w)\n"
               "print(sorted({m.split('.')[0] for m in sys.modules}"
               " & {'flax', 'orbax'}))"],
    "module": ["-m", "gwen_tpu", "runs", "--help"],
}


@pytest.mark.parametrize("how", sorted(_ALIAS_CHECKS))
def test_former_package_name_still_works(how):
    from pathlib import Path

    res = _run(_ALIAS_CHECKS[how], Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    if how == "import":
        assert res.stdout.strip() == "[]"
    else:
        assert "usage:" in res.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """The smoke script exits non-zero and prints no result on the CPU,
    and in a directory that holds nothing else of the repository."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    cwd = root
    if where == "alone":
        shutil.copy(root / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run(["chip_smoke.py"], cwd)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
