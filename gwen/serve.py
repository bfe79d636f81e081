"""Model export / serving: self-contained AOT artifacts via ``jax.export``.

The reference's only model persistence is MLflow artifact logging reloaded
in-process by the training stack (models_cnn.py:553-559, utils.py:412-442).
A production serving deployment wants a *self-contained* artifact: the
compiled computation plus its weights and graph tables, loadable without the
model code or the training configuration.

An exported artifact directory holds:

* ``model.stablehlo`` — the StableHLO bytecode of the jitted forward step
  exported with :func:`jax.export.export` (params, graph tables and the
  input state are *arguments* of the exported computation, so weights can
  be hot-swapped);
* ``arrays.npz`` — every array leaf of the params and graph pytrees
  (:mod:`gwen.npz_io`);
* ``meta.json`` — pytree structure specs (a small JSON codec that round-
  trips dicts/lists/tuples and the graph containers), the fields that
  rebuild each ``jax.export.Exported`` around its bytecode, the export
  platform, the JAX version, the artifact format, and caller metadata.

The ``Exported`` fields in ``meta.json`` stand in for JAX's own serializer
(``Exported.serialize``), which needs the ``flatbuffers`` package that a
GPU host may lack. They are private fields of ``jax.export.Exported``, so an
artifact loads only under the JAX version that wrote it: :meth:`ServingModel.
load` checks the version and the format and says so, and an artifact from
another version (or one written by ``Exported.serialize``) is exported anew
with ``gwen export``. Once ``flatbuffers`` is a dependency everywhere, the
stand-in goes back to ``Exported.serialize``.

:class:`ServingModel` loads the directory and serves ``step``/``rollout``.
A GPU forward that contains the diagonal-window Triton kernel exports it as
a Triton custom call, which ``jax.export`` does not list as stable across
versions, so the export names it in ``disabled_checks``; CPU artifacts use
the plain-XLA path.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any

import numpy as np

from gwen.npz_io import load_arrays, save_arrays

# Graph containers the codec can reconstruct (pytree dataclasses).
_STRUCT_REGISTRY: dict[str, Any] = {}


def _registry() -> dict[str, Any]:
    if not _STRUCT_REGISTRY:
        from gwen.graph import graph as gmod

        for name in (
            "Graph", "DenseGraph", "BlockEllGraph", "BlockTileGraph",
            "WindowedDenseGraph", "SlidingDenseGraph", "SlidingRank1Graph",
            "SlidingPackedGraph", "DiagWindowGraph", "EscapeFixup",
            "MultiLevelGraph",
        ):
            _STRUCT_REGISTRY[name] = getattr(gmod, name)
    return _STRUCT_REGISTRY


def _is_array(x) -> bool:
    import jax

    return isinstance(x, (np.ndarray, jax.Array))


def pack_tree(tree, leaves: list) -> Any:
    """Encode a pytree (dicts/lists/tuples/None/scalars/arrays/graph
    structs) as a JSON-able spec; array leaves are appended to ``leaves``
    and referenced by index (stored by :mod:`gwen.npz_io`, which keeps
    extension dtypes such as bfloat16)."""
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"k": "lit", "v": tree}
    if _is_array(tree):
        leaf = np.asarray(tree)
        leaves.append(leaf)
        return {"k": "arr", "i": len(leaves) - 1}
    if isinstance(tree, dict):
        return {"k": "dict",
                "v": {str(key): pack_tree(val, leaves)
                      for key, val in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"k": "list" if isinstance(tree, list) else "tuple",
                "v": [pack_tree(v, leaves) for v in tree]}
    cls = type(tree)
    if dataclasses.is_dataclass(tree) and cls.__name__ in _registry():
        return {"k": "struct", "c": cls.__name__,
                "v": {f.name: pack_tree(getattr(tree, f.name), leaves)
                      for f in dataclasses.fields(tree)}}
    raise TypeError(f"pack_tree: unsupported node type {cls.__name__}")


def unpack_tree(spec: Any, leaves: list) -> Any:
    """Inverse of :func:`pack_tree`."""
    kind = spec["k"]
    if kind == "lit":
        return spec["v"]
    if kind == "arr":
        return leaves[spec["i"]]
    if kind == "dict":
        return {key: unpack_tree(val, leaves) for key, val in spec["v"].items()}
    if kind == "list":
        return [unpack_tree(v, leaves) for v in spec["v"]]
    if kind == "tuple":
        return tuple(unpack_tree(v, leaves) for v in spec["v"])
    if kind == "struct":
        cls = _registry()[spec["c"]]
        return cls(**{key: unpack_tree(val, leaves)
                      for key, val in spec["v"].items()})
    raise ValueError(f"unpack_tree: unknown node kind {kind!r}")


# Version of the artifact layout written by export_model: the StableHLO
# bytecode plus the Exported fields in meta.json (no flatbuffers).
ARTIFACT_FORMAT = 2


def _shapes_of(tree):
    import jax

    return jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype)
        if _is_array(a) else a,
        tree,
    )


# Custom-call targets a Pallas-Triton kernel lowers to ("__gpu$xla.gpu.
# triton" in this JAX, "triton_kernel_call" in older ones); jax.export lists
# neither as stable.
_CUSTOM_CALL = re.compile(r"custom_call @([\w$.]+)")


def _disabled_checks(fn, args) -> list:
    """``DisabledSafetyCheck.custom_call`` for each Triton target in the
    lowered forward (none when the forward has no Triton kernel)."""
    import jax

    targets = set(_CUSTOM_CALL.findall(fn.lower(*args).as_text()))
    return [jax.export.DisabledSafetyCheck.custom_call(t)
            for t in sorted(targets) if "triton" in t]


def _write_exported(exp, path: Path) -> dict:
    """Write ``exp``'s StableHLO bytecode to ``path``; return the JSON
    fields :func:`_read_exported` rebuilds it from. Single-device exports
    without effects only (what :func:`export_model` produces). The stand-in
    for ``Exported.serialize`` (module docstring): it reads private fields
    of this JAX version's ``Exported``."""
    shardings = (exp.in_shardings_hlo + exp.out_shardings_hlo
                 + tuple(exp._in_named_shardings)
                 + tuple(exp._out_named_shardings))
    if (exp.nr_devices != 1 or exp.ordered_effects or exp.unordered_effects
            or any(s is not None for s in shardings)):
        raise ValueError("only single-device exports without effects or "
                         "shardings are stored")
    path.write_bytes(exp.mlir_module_serialized)
    return {
        "fun_name": exp.fun_name,
        "in_avals": [[list(a.shape), a.dtype.name] for a in exp.in_avals],
        "out_avals": [[list(a.shape), a.dtype.name] for a in exp.out_avals],
        "platforms": list(exp.platforms),
        "disabled_checks": [dc._impl for dc in exp.disabled_safety_checks],
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": bool(exp.uses_global_constants),
    }


def _read_exported(header: dict, path: Path, in_tree):
    """Inverse of :func:`_write_exported` (the output is one array)."""
    import jax
    import jax.numpy as jnp

    def avals(xs):
        return tuple(jax.core.ShapedArray(tuple(shape), jnp.dtype(dt))
                     for shape, dt in xs)

    n_in, n_out = len(header["in_avals"]), len(header["out_avals"])
    return jax.export.Exported(
        fun_name=header["fun_name"],
        in_tree=in_tree,
        in_avals=avals(header["in_avals"]),
        out_tree=jax.tree_util.tree_structure(0),
        out_avals=avals(header["out_avals"]),
        _has_named_shardings=True,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=1,
        platforms=tuple(header["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=tuple(
            jax.export.DisabledSafetyCheck(c)
            for c in header["disabled_checks"]),
        mlir_module_serialized=path.read_bytes(),
        calling_convention_version=header["calling_convention_version"],
        module_kept_var_idx=tuple(header["module_kept_var_idx"]),
        uses_global_constants=header["uses_global_constants"],
        _get_vjp=None,
    )


def _check_loadable(meta: dict, path: Path) -> None:
    """Refuse an artifact this JAX cannot rebuild, with the reason."""
    import jax

    fmt = meta.get("format")
    if fmt != ARTIFACT_FORMAT:
        raise ValueError(
            f"{path}: artifact format {fmt!r}, this version reads format "
            f"{ARTIFACT_FORMAT} (artifacts without a format were written by "
            f"Exported.serialize); export the model again with `gwen export`")
    if meta["jax_version"] != jax.__version__:
        raise ValueError(
            f"{path}: artifact written under JAX {meta['jax_version']}, "
            f"running JAX {jax.__version__}; its Exported fields are tied to "
            f"the JAX version that wrote them, so export the model again "
            f"with `gwen export`")


def save_tree(tree, stem) -> None:
    """Write a pytree of arrays as ``<stem>.npz`` + ``<stem>.json`` (the
    codec of :func:`pack_tree`)."""
    leaves: list = []
    spec = pack_tree(tree, leaves)
    stem = Path(stem)
    save_arrays(stem.with_suffix(".npz"), leaves)
    stem.with_suffix(".json").write_text(json.dumps(spec))


def load_tree(stem):
    """Inverse of :func:`save_tree`."""
    stem = Path(stem)
    spec = json.loads(stem.with_suffix(".json").read_text())
    return unpack_tree(spec, load_arrays(stem.with_suffix(".npz")))


def export_model(model, params, graph, sample_input, path,
                 metadata: "dict | None" = None,
                 rollout_steps: int = 0) -> Path:
    """Export ``model.apply(params, graph, x)`` as a serving artifact.

    ``sample_input`` fixes the input shape/dtype (serving is static-shape).
    With ``rollout_steps > 0`` a ``lax.scan``-based
    autoregressive rollout of that many steps is exported alongside the
    single step (``rollout.stablehlo``): one dispatch produces the whole
    stacked trajectory on device, instead of a host loop paying per-step
    dispatch latency and state round-trips. Returns the artifact directory.
    """
    import jax

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)

    # Export over FLAT leaf lists: jax.export cannot serialize treedefs
    # containing custom pytree nodes (the graph containers), so
    # the structure is closed over at trace time and rebuilt at load time
    # from meta.json by the same codec.
    p_leaves, p_def = jax.tree_util.tree_flatten(params)
    g_leaves, g_def = jax.tree_util.tree_flatten(graph)

    def step(p_flat, g_flat, x):
        p = jax.tree_util.tree_unflatten(p_def, p_flat)
        g = jax.tree_util.tree_unflatten(g_def, g_flat)
        return model.apply(p, g, x)

    x_spec = jax.ShapeDtypeStruct(np.shape(sample_input),
                                  np.asarray(sample_input).dtype)
    args = (_shapes_of(p_leaves), _shapes_of(g_leaves), x_spec)
    checks = _disabled_checks(jax.jit(step), args)
    exported = jax.export.export(jax.jit(step), disabled_checks=checks)(*args)
    exports = {"model": _write_exported(exported, path / "model.stablehlo")}

    if rollout_steps > 0:
        def rollout(p_flat, g_flat, x):
            def body(carry, _):
                y = step(p_flat, g_flat, carry)
                return y, y

            _, ys = jax.lax.scan(body, x, None, length=rollout_steps)
            return ys

        exp_roll = jax.export.export(jax.jit(rollout),
                                     disabled_checks=checks)(*args)
        exports["rollout"] = _write_exported(exp_roll,
                                             path / "rollout.stablehlo")

    leaves: list[np.ndarray] = []
    spec = {
        "params": pack_tree(params, leaves),
        "graph": pack_tree(graph, leaves),
        "input": {"shape": list(np.shape(sample_input)),
                  "dtype": np.asarray(sample_input).dtype.name},
        "platforms": list(exported.platforms),
        "exports": exports,
        "leaf_counts": [len(p_leaves), len(g_leaves)],
        "format": ARTIFACT_FORMAT,
        "jax_version": jax.__version__,
        "rollout_steps": int(rollout_steps),
        "metadata": metadata or {},
    }
    save_arrays(path / "arrays.npz", leaves)
    (path / "meta.json").write_text(json.dumps(spec))
    return path


class ServingModel:
    """A loaded serving artifact: ``step`` one forward, ``rollout`` many.

    ``load`` needs only this module — not the model class, training config,
    or graph builders.
    """

    def __init__(self, exported, params, graph, meta: dict,
                 exported_rollout=None):
        self._exported = exported
        self._exported_rollout = exported_rollout
        self.params = params
        self.graph = graph
        self.meta = meta

    @classmethod
    def load(cls, path) -> "ServingModel":
        import jax

        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        _check_loadable(meta, path)
        n_p, n_g = meta["leaf_counts"]
        in_tree = jax.tree_util.tree_structure((([0] * n_p, [0] * n_g, 0),
                                                {}))
        exports = meta["exports"]
        exported = _read_exported(exports["model"], path / "model.stablehlo",
                                  in_tree)
        roll = None
        if "rollout" in exports:
            roll = _read_exported(exports["rollout"],
                                  path / "rollout.stablehlo", in_tree)
        leaves = load_arrays(path / "arrays.npz")
        params = unpack_tree(meta["params"], leaves)
        graph = unpack_tree(meta["graph"], leaves)
        return cls(exported, params, graph, meta, exported_rollout=roll)

    @property
    def input_shape(self) -> tuple:
        return tuple(self.meta["input"]["shape"])

    def step(self, x):
        """One forward step on the exported computation."""
        import jax

        p_flat = jax.tree_util.tree_leaves(self.params)
        g_flat = jax.tree_util.tree_leaves(self.graph)
        return self._exported.call(p_flat, g_flat, x)

    @property
    def rollout_steps(self) -> int:
        return int(self.meta.get("rollout_steps", 0))

    def rollout(self, x0, num_steps: int):
        """Autoregressive rollout: feed each prediction back as input.
        Returns the stacked trajectory (num_steps, *state_shape).

        When the artifact carries a scan-based rollout export (R steps per
        dispatch), the trajectory is produced in ⌈num_steps/R⌉ dispatches
        with states staying on device — not a host loop paying per-step
        dispatch latency and state round-trips."""
        import jax
        import jax.numpy as jnp

        r = self.rollout_steps
        if self._exported_rollout is not None and r > 0:
            p_flat = jax.tree_util.tree_leaves(self.params)
            g_flat = jax.tree_util.tree_leaves(self.graph)
            chunks = []
            x = x0
            for _ in range((num_steps + r - 1) // r):
                ys = self._exported_rollout.call(p_flat, g_flat, x)
                chunks.append(ys)
                x = ys[-1]
            return jnp.concatenate(chunks, axis=0)[:num_steps]

        states = []
        x = x0
        for _ in range(num_steps):
            x = self.step(x)
            states.append(x)
        return jnp.stack(states)
