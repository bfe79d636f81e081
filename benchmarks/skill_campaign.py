"""Skill-parity campaign: GCN vs attention vs interaction processors
(VERDICT r4 #5).

Same data, same budget, same calibration for every processor family:
drives the train-mesh workflow (`gwen.cli.train_mesh.main`) once per
processor and prints one JSON line each with the held-out skill scores
(fair CRPS, ensemble-mean RMSE, spread/error ratio after closed-form
inflation calibration). The reference's raison d'être is ensemble skill
(loss_functions.py:41-123) but it publishes no numbers (BASELINE.md) —
this table IS the baseline, self-established.

  GWEN_SKILL_LEVELS=6 GWEN_SKILL_EPOCHS=3 GWEN_SKILL_PROCS=gcn,attention \
      python benchmarks/skill_campaign.py

All runs share one process (one device client); runs are sequential —
one process per card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    from gwen.compile_cache import enable_compile_cache

    enable_compile_cache()

    from gwen.cli import train_mesh
    from gwen.config import GwenConfig

    levels = int(os.environ.get("GWEN_SKILL_LEVELS", "6"))
    epochs = int(os.environ.get("GWEN_SKILL_EPOCHS", "3"))
    latent = int(os.environ.get("GWEN_SKILL_LATENT", "128"))
    steps = int(os.environ.get("GWEN_SKILL_PSTEPS", "2"))
    members = int(os.environ.get("GWEN_SKILL_MEMBERS", "4"))
    tsteps = int(os.environ.get("GWEN_SKILL_TSTEPS", "16"))
    procs = os.environ.get(
        "GWEN_SKILL_PROCS", "gcn,attention,interaction"
    ).split(",")

    rows = []
    for proc in procs:
        proc = proc.strip()
        cfg = GwenConfig()
        cfg.graph.refine = levels
        cfg.model.architecture = "encode-process-decode"
        cfg.model.latent_size = latent
        cfg.model.process_steps = steps
        cfg.model.processor = proc
        cfg.train.epochs = epochs
        cfg.train.calibrate_inflation = True
        # remat is numerics-identical, so enabling it for a memory-bound
        # family (the interaction net's (E, latent) edge tensors OOM by
        # ~250 MB at L6 defaults) keeps the comparison fair.
        if os.environ.get("GWEN_SKILL_REMAT"):
            cfg.train.remat = True
        cfg.run.registry_root = os.environ.get(
            "GWEN_SKILL_REGISTRY", "runs"
        )
        cfg.run.run_name = f"skill_{proc}_L{levels}"
        t0 = time.time()
        out = train_mesh.main(cfg, members=members, steps=tsteps)
        row = {
            "processor": proc,
            "levels": levels,
            "latent": latent,
            "process_steps": steps,
            "epochs": epochs,
            "train_members": members - 1,
            "best_train_loss": round(out["best_train_loss"], 6),
            "crps": round(out["skill_crps"], 6),
            "rmse_ensemble_mean": round(out["skill_rmse_ensemble_mean"], 6),
            "spread_error_ratio": round(out["skill_spread_error_ratio"], 4),
            "wall_s": round(time.time() - t0, 1),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    if len(rows) > 1:
        best = min(rows, key=lambda r: r["crps"])
        print(json.dumps({"campaign_best": best["processor"],
                          "crps": best["crps"]}), flush=True)


if __name__ == "__main__":
    main()
