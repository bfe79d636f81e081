"""Filesystem experiment registry (replaces the reference's MLflow usage).

Reference behavior being covered:

* ``setup_mlflow`` (loggers_configs.py:69-99): experiment selection (hostname
  sniffing CSCS ``nid*`` → "GWEN_balfrin") → here an explicit experiment name
  with an optional ``GWEN_SITE`` env suffix.
* per-epoch ``mlflow.log_metric("loss", ...)`` (models_gnn.py:383) →
  ``Run.log_metric`` into ``metrics.jsonl``.
* best-model artifact logging (``mlflow.pytorch.log_model``,
  models_gnn.py:384-387) → ``Run.save_artifact`` of params + model config.
* ``get_runs`` newest-first filtered to non-empty artifact dirs
  (utils.py:382-409) and ``load_best_model`` (utils.py:412-442). The
  reference's "best" is just "most recent" (admitted at utils.py:428);
  here :func:`load_best_model` honestly picks the run with the lowest
  recorded best loss, with ``strategy="latest"`` for parity.

Layout::

    <root>/<experiment>/<run_id>/
        meta.json        # config snapshot, status, timestamps, best metric
        metrics.jsonl    # one JSON object per logged metric
        artifacts/       # saved model params (params.npz + params.json)
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from gwen.logging_utils import get_logger

log = get_logger()


def _environment_snapshot() -> dict:
    """Versions of the stack that produced a model artifact (reference pins
    pip requirements with the best model, models_cnn.py:553-559)."""
    import platform
    import sys

    versions = {}
    for mod in ("jax", "jaxlib", "optax", "numpy"):
        try:
            m = __import__(mod)
            for part in mod.split(".")[1:]:
                m = getattr(m, part)
            versions[mod] = getattr(m, "__version__", "unknown")
        except Exception:  # pragma: no cover - optional deps
            versions[mod] = "unavailable"
    from gwen.version import __version__ as gwen_version

    return {
        "gwen": gwen_version,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "packages": versions,
    }


def default_experiment(base: str = "GWEN") -> str:
    """Experiment name, site-suffixed like the reference's hostname sniffing."""
    site = os.environ.get("GWEN_SITE")
    if site:
        return f"{base}_{site}"
    host = socket.gethostname()
    if host.startswith("nid"):  # CSCS compute node convention kept for parity
        return f"{base}_balfrin"
    return base


@dataclass
class Run:
    path: Path

    @property
    def run_id(self) -> str:
        return self.path.name

    @property
    def meta(self) -> dict:
        p = self.path / "meta.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def _update_meta(self, **kv: Any) -> None:
        meta = self.meta
        meta.update(kv)
        (self.path / "meta.json").write_text(json.dumps(meta, indent=2, default=str))

    def log_metric(self, name: str, value: float, step: int = 0) -> None:
        with (self.path / "metrics.jsonl").open("a") as f:
            f.write(
                json.dumps(
                    {"name": name, "value": float(value), "step": int(step), "ts": time.time()}
                )
                + "\n"
            )

    def metrics(self, name: Optional[str] = None) -> list[dict]:
        p = self.path / "metrics.jsonl"
        if not p.exists():
            return []
        rows = [json.loads(line) for line in p.read_text().splitlines() if line]
        return [r for r in rows if name is None or r["name"] == name]

    def save_model(self, params, model_config: dict, best_metric: float | None = None) -> None:
        art = self.path / "artifacts"
        art.mkdir(exist_ok=True)
        from gwen.serve import save_tree

        save_tree(params, art / "params")
        (art / "model.json").write_text(json.dumps(model_config, indent=2, default=str))
        # Environment pinning alongside the artifact (reference logs pip
        # requirements with the best model, models_cnn.py:553-559) — the
        # stack versions that produced these params, for reproducibility.
        (art / "environment.json").write_text(
            json.dumps(_environment_snapshot(), indent=2)
        )
        if best_metric is not None:
            self._update_meta(best_metric=float(best_metric))

    def environment(self) -> dict:
        """The pinned environment saved with the model artifact (if any)."""
        p = self.path / "artifacts" / "environment.json"
        return json.loads(p.read_text()) if p.exists() else {}

    def load_model(self, params_template=None):
        art = self.path / "artifacts"
        from gwen.serve import load_tree

        params = load_tree(art / "params")
        model_config = json.loads((art / "model.json").read_text())
        if params_template is not None:
            import jax

            params = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(params_template),
                jax.tree_util.tree_leaves(params))
        return params, model_config

    def has_artifacts(self) -> bool:
        art = self.path / "artifacts"
        return art.exists() and any(art.iterdir())

    def finish(self, status: str = "FINISHED") -> None:
        self._update_meta(status=status, end_time=time.time())


class Registry:
    def __init__(self, root: str | Path = "runs"):
        self.root = Path(root)

    def create_run(
        self, experiment: str, config: dict | None = None, run_name: str = ""
    ) -> Run:
        run_id = time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:6]
        if run_name:
            run_id = f"{run_id}-{run_name}"
        path = self.root / experiment / run_id
        path.mkdir(parents=True, exist_ok=False)
        run = Run(path)
        (path / "meta.json").write_text(
            json.dumps(
                {
                    "experiment": experiment,
                    "run_id": run_id,
                    "status": "RUNNING",
                    "start_time": time.time(),
                    "config": config or {},
                },
                indent=2,
                default=str,
            )
        )
        return run

    def get_runs(self, experiment: str, with_artifacts_only: bool = True) -> list[Run]:
        """Runs newest-first (utils.py:382-409)."""
        exp = self.root / experiment
        if not exp.exists():
            return []
        runs = [Run(p) for p in exp.iterdir() if p.is_dir()]
        if with_artifacts_only:
            runs = [r for r in runs if r.has_artifacts()]
        return sorted(runs, key=lambda r: r.meta.get("start_time", 0), reverse=True)

    def load_best_model(
        self, experiment: str, params_template=None, strategy: str = "best"
    ):
        """Load params+config from the best (lowest best_metric) or latest run.

        ``strategy="latest"`` reproduces the reference's actual behavior
        (utils.py:412-442 takes the most recent run).
        """
        runs = self.get_runs(experiment)
        if not runs:
            raise FileNotFoundError(f"no runs with artifacts in experiment {experiment!r}")
        if strategy == "latest":
            chosen = runs[0]
        else:
            scored = [r for r in runs if "best_metric" in r.meta]
            chosen = (
                min(scored, key=lambda r: r.meta["best_metric"]) if scored else runs[0]
            )
        log.info("loading model from run %s", chosen.run_id)
        return chosen.load_model(params_template)
