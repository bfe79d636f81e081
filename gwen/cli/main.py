"""Command-line interface.

The reference has no real training CLI (the argparse interface documented in
train_gnn.py:26-38 doesn't exist; only create_gif.py has a click CLI).
Here every pipeline stage is a subcommand with ``section.key=value`` config
overrides::

    gwen ingest      [--config cfg.json] [overrides...]
    gwen preprocess  [--config cfg.json] [overrides...]
    gwen train-gnn   [--config cfg.json] [--no-animate] [overrides...]
    gwen train-cnn   [--config cfg.json] [--no-animate] [overrides...]
    gwen gif         --input data.zarr [--var theta_v] [--out output]
    gwen bench       [overrides...]
"""

from __future__ import annotations

import argparse
import json
import sys

from gwen.config import GwenConfig, load_config
from gwen.logging_utils import setup_logger, suppress_warnings


def _cfg(args) -> GwenConfig:
    cfg = load_config(args.config)
    cfg.apply_overrides(args.overrides)
    return cfg


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="config JSON (nested or reference-flat)")
    p.add_argument("overrides", nargs="*", help="section.key=value overrides")


def main(argv: list[str] | None = None) -> int:
    from gwen.compile_cache import enable_compile_cache

    suppress_warnings()
    setup_logger()
    enable_compile_cache()
    parser = argparse.ArgumentParser(prog="gwen", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name in ("ingest", "preprocess", "train-gnn", "train-cnn", "train-mesh",
                 "make-mesh-data", "bench"):
        p = sub.add_parser(name)
        _add_common(p)
        if name in ("train-gnn", "train-cnn"):
            p.add_argument("--no-animate", action="store_true")
            p.add_argument("--out-dir", default="output")
        if name == "make-mesh-data":
            p.add_argument("--out", required=True)
            p.add_argument("--members", type=int, default=4)
            p.add_argument("--steps", type=int, default=16)
        if name == "train-mesh":
            p.add_argument("--members", type=int, default=4)
            p.add_argument("--steps", type=int, default=16)
            p.add_argument("--data", default="",
                           help="mesh-ensemble zarr store (default: synthetic)")

    exp = sub.add_parser("export")
    _add_common(exp)
    exp.add_argument("--out", required=True, help="artifact directory")
    exp.add_argument("--data", default="",
                     help="mesh zarr for graph rebuild (default: icosphere "
                          "from the run's levels)")
    exp.add_argument("--experiment", default="",
                     help="registry experiment (default: <run.experiment>_MESH)")
    exp.add_argument("--rollout-steps", type=int, default=4,
                     help="steps per dispatch in the scan-based rollout "
                          "export (0 disables the rollout artifact)")

    prd = sub.add_parser("predict")
    prd.add_argument("--artifact", required=True, help="exported artifact dir")
    prd.add_argument("--input", required=True,
                     help=".npy initial state (nodes, channels)")
    prd.add_argument("--steps", type=int, default=1)
    prd.add_argument("--out", default="predictions.npy")

    rns = sub.add_parser("runs")
    rns.add_argument("--experiment", default=None, help="default: all experiments")
    rns.add_argument("--root", default="runs")

    g = sub.add_parser("gif")
    g.add_argument("--input", default=None,
                   help="zarr store with (time, member, height, ncells); "
                        "prompted interactively when omitted")
    g.add_argument("--var", default="theta_v")
    g.add_argument("--out", default="output")
    g.add_argument("--member", default=None, help="member index or id (default: all)")

    args = parser.parse_args(argv)

    if args.cmd == "ingest":
        from gwen.data.ingest import ingest

        arch = ingest(_cfg(args).data)
        print(json.dumps({"zarr": str(arch.path), "shape": list(arch.shape)}))
    elif args.cmd == "preprocess":
        from gwen.data.preprocess import preprocess

        train, test = preprocess(_cfg(args).data)
        print(json.dumps({"train": str(train), "test": str(test)}))
    elif args.cmd == "train-gnn":
        from gwen.cli.train_gnn import main as run

        out = run(_cfg(args), animate=not args.no_animate, out_dir=args.out_dir)
        print(json.dumps(out))
    elif args.cmd == "train-cnn":
        from gwen.cli.train_cnn import main as run

        out = run(_cfg(args), animate=not args.no_animate, out_dir=args.out_dir)
        print(json.dumps(out))
    elif args.cmd == "train-mesh":
        from gwen.cli.train_mesh import main as run

        out = run(_cfg(args), members=args.members, steps=args.steps, data=args.data)
        print(json.dumps(out))
    elif args.cmd == "make-mesh-data":
        from gwen.data.meshstore import save_mesh_dataset
        from gwen.data.synthetic import mesh_ensemble_dataset

        cfg = _cfg(args)
        fields, verts, s, r = mesh_ensemble_dataset(
            levels=cfg.graph.refine, members=args.members, steps=args.steps,
            seed=cfg.train.seed,
        )
        path = save_mesh_dataset(args.out, fields, s, r, verts)
        print(json.dumps({"path": str(path), "fields": list(fields.shape)}))
    elif args.cmd == "export":
        from gwen.cli.export_cli import export_main

        out = export_main(_cfg(args), out=args.out, data=args.data,
                          experiment=args.experiment,
                          rollout_steps=args.rollout_steps)
        print(json.dumps(out))
    elif args.cmd == "predict":
        from gwen.cli.export_cli import predict_main

        out = predict_main(args.artifact, args.input, args.steps, args.out)
        print(json.dumps(out))
    elif args.cmd == "bench":
        import runpy
        from pathlib import Path

        bench = Path(__file__).resolve().parents[2] / "bench.py"
        runpy.run_path(str(bench), run_name="__main__")
    elif args.cmd == "runs":
        from pathlib import Path

        from gwen.registry import Registry

        reg = Registry(args.root)
        exps = ([args.experiment] if args.experiment
                else sorted(p.name for p in Path(args.root).iterdir() if p.is_dir())
                if Path(args.root).exists() else [])
        rows = []
        for exp in exps:
            if exp == "checkpoints":
                continue
            for r in reg.get_runs(exp, with_artifacts_only=False):
                meta = r.meta
                rows.append({
                    "experiment": exp,
                    "run_id": r.run_id,
                    "status": meta.get("status"),
                    "best_metric": meta.get("best_metric"),
                })
        print(json.dumps(rows, indent=2))
    elif args.cmd == "gif":
        import numpy as np

        from gwen import viz
        from gwen.data import zarrstore

        if args.input is None:
            # Interactive fallback, matching the reference's bare-invocation
            # prompts (create_gif.py:305-315: input() for file/var/out-dir).
            args.input = input("Enter the path to the input zarr store: ").strip()
            var = input(f"Enter the variable name [{args.var}]: ").strip()
            out = input(f"Enter the output directory [{args.out}]: ").strip()
            args.var = var or args.var
            args.out = out or args.out
        arr = zarrstore.open_array(args.input)
        data = arr.read()
        members = arr.meta.get("members") or [str(i) for i in range(data.shape[1])]
        idxs = range(data.shape[1])
        if args.member is not None:
            idxs = [int(args.member)] if args.member.isdigit() else [
                members.index(args.member)
            ]
        paths = []
        for m in idxs:
            paths.append(str(viz.create_animation(
                np.asarray(data[:, m]), members[m], args.out, var_name=args.var
            )))
        print(json.dumps({"gifs": paths}))
    return 0


def cli_entry() -> int:
    """Console entry with friendly error reporting (no tracebacks for
    expected failures — missing files, bad config keys)."""
    try:
        return main()
    except (FileNotFoundError, KeyError, ValueError) as e:
        print(f"gwen: error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(cli_entry())
