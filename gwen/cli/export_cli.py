"""``gwen export`` / ``gwen predict`` — serving artifacts.

Export packages a trained mesh model from the registry into a
self-contained AOT artifact (:mod:`gwen.serve`); predict loads such an
artifact and runs an autoregressive rollout from an initial state. The
reference has no serving story at all (reload happens inside the training
stack, utils.py:412-442) — this is the production-deployment extension.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gwen.config import GwenConfig
from gwen.logging_utils import get_logger
from gwen.registry import Registry, default_experiment

log = get_logger()


def _resolve_hparams(meta: dict, config: GwenConfig) -> dict:
    """Model hyperparameters for export: the run's stored values are
    authoritative. A CLI value that differs from BOTH the stored value and
    the dataclass default is an explicit conflicting override → error
    (a mismatched processor/attn_heads/residual/mlp_layers yields identical
    param shapes, so export would silently serve wrong predictions; a
    mismatched diag_window silently changes the attention neighbourhood).
    Runs recorded before these keys existed fall back to the CLI value."""
    model_d, mesh_d = type(config.model)(), type(config.mesh)()
    spec = [
        ("processor", config.model.processor, model_d.processor),
        ("attn_heads", config.model.attn_heads, model_d.attn_heads),
        ("residual", config.model.residual, model_d.residual),
        ("mlp_layers", config.model.mlp_layers, model_d.mlp_layers),
        ("compute_dtype", config.model.compute_dtype, model_d.compute_dtype),
        ("diag_window", config.mesh.diag_window, mesh_d.diag_window),
    ]
    out = {}
    for name, cli_val, default in spec:
        stored = meta.get(name)
        if stored is None:
            out[name] = cli_val
        elif cli_val != default and cli_val != stored:
            raise ValueError(
                f"export: run was trained with {name}={stored!r} but the "
                f"CLI sets {name}={cli_val!r}; drop the override — stored "
                "hyperparameters are authoritative")
        else:
            out[name] = stored
    return out


def export_main(config: GwenConfig, out: str, data: str = "",
                experiment: str = "", rollout_steps: int = 4) -> dict:
    """Load the best mesh-model run, rebuild its serving graph, export."""
    import jax
    import jax.numpy as jnp

    from gwen.graph import (
        apply_order,
        build_graph,
        icosphere_edges,
        kd_patch_order,
        rcm_order,
        to_diag_window,
    )
    from gwen.nn import EncodeProcessDecode
    from gwen.serve import export_model

    registry = Registry(config.run.registry_root)
    experiment = experiment or (
        (config.run.experiment or default_experiment()) + "_MESH")
    params, meta = registry.load_best_model(experiment)

    hp = _resolve_hparams(meta, config)
    if data:
        from gwen.data.meshstore import load_mesh_dataset

        _fields, s, r, verts, _m = load_mesh_dataset(data, lazy=True)
        n = int(max(s.max(), r.max())) + 1
    else:
        if meta.get("data"):
            log.info("run was trained on %s; exporting against the L%s "
                     "icosphere — pass --data to use the training mesh",
                     meta["data"], meta["levels"])
        verts, s, r = icosphere_edges(int(meta["levels"]))
        n = verts.shape[0]
    if meta.get("nodes") is not None and n != int(meta["nodes"]):
        raise ValueError(
            f"export: rebuilt mesh has {n} nodes but the run was trained on "
            f"{meta['nodes']} (data={meta.get('data') or 'icosphere'}); pass "
            "--data pointing at the training dataset")

    processor = hp["processor"]
    compute_dtype = (
        jnp.bfloat16 if hp["compute_dtype"] == "bfloat16" else jnp.float32
    )
    # Serving layout mirrors train-mesh: diag-window (KD order) whenever
    # vertex positions exist, COO/segment otherwise; the implementation
    # under the diag layout is the platform's choice.
    use_diag = verts is not None
    if use_diag:
        perm = kd_patch_order(np.asarray(verts), s, r, n)
    else:
        perm = rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    g = build_graph(s2, r2, n)
    if use_diag:
        graph = to_diag_window(
            g, window_size=hp["diag_window"], dtype=compute_dtype,
            device_build=True,
        )
        backend = "auto"
    else:
        graph = g
        backend = "segment"

    ch = int(meta["channels"])
    model = EncodeProcessDecode(
        channels_in=ch, channels_out=ch,
        latent_size=int(meta["latent_size"]),
        process_steps=int(meta["process_steps"]),
        mlp_layers=int(hp["mlp_layers"]),
        residual=bool(hp["residual"]),
        compute_dtype=compute_dtype,
        backend=backend,
        processor=processor,
        attn_heads=int(hp["attn_heads"]),
    )
    sample = np.zeros((n, ch), np.float32)
    # Node ordering is free to differ from training: every op is per-node or
    # graph-equivariant, so params are order-agnostic as long as the graph
    # and the states use one consistent permutation (saved with the
    # artifact; predict maps in/out of it).
    path = export_model(model, params, graph, sample, out, metadata={
        **meta,
        "experiment": experiment,
        "node_order": "kd" if use_diag else "rcm",
        "processor": processor,
    }, rollout_steps=rollout_steps)
    # The node permutation matters to serve correctly-ordered inputs; store
    # it as its own array (meta.json stays small).
    np.save(Path(path) / "node_perm.npy", np.asarray(perm, np.int64))
    result = {
        "artifact": str(path),
        "nodes": n,
        "channels": ch,
        "platform": jax.default_backend(),
    }
    log.info("exported %s", result)
    return result


def predict_main(artifact: str, input_path: str, steps: int,
                 out: str) -> dict:
    """Load a serving artifact and roll out from an initial state.

    The input is a ``(nodes, channels)`` .npy in *original* node order; the
    artifact's stored permutation maps to/from kernel order.
    """
    from gwen.serve import ServingModel

    sm = ServingModel.load(artifact)
    x0 = np.load(input_path)
    if tuple(x0.shape) != sm.input_shape:
        raise ValueError(
            f"input shape {x0.shape} != artifact input {sm.input_shape}")
    perm_path = Path(artifact) / "node_perm.npy"
    perm = np.load(perm_path) if perm_path.exists() else None
    if perm is not None and perm.size:
        x0 = x0[perm]
    traj = np.asarray(sm.rollout(x0.astype(np.float32), steps))
    if perm is not None and perm.size:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        traj = traj[:, inv]
    np.save(out, traj)
    result = {"out": out, "steps": steps, "shape": list(traj.shape)}
    log.info("predicted %s", result)
    return result
