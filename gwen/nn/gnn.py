"""GNN model family.

* :class:`GCNStack` — parity with the reference's encoder-decoder GCN
  (models_gnn.py:86-303): width schedule ``ch_in -> h -> h/2 -> h/4 -> h/2 ->
  h -> ch_out`` with ReLU between all layers and none after the last
  (upconv5, models_gnn.py:184,206). The reference defines deeper stacks
  (conv4/5, upconv1/2) but comments them out of forward
  (models_gnn.py:150-151, 202-203); ``down_layers``/``up_layers`` default to
  the active 3+3.
* :class:`EncodeProcessDecode` — the mesh-scale model (BASELINE.json north
  star): node-wise encoder MLP, K message-passing processor steps with
  residual + layer norm, node-wise decoder MLP.

Both are pure ``init``/``apply`` definitions over a graph container from
``gwen.graph``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from gwen.nn import core
from gwen.nn.layers import gcn_apply, gcn_init

Array = jnp.ndarray


def _width_schedule(ch_in: int, hidden: int, ch_out: int, down: int, up: int) -> list[int]:
    """Reference width schedule (models_gnn.py:106-206), generalized to depth."""
    downs = [hidden // (2**i) for i in range(down)]  # h, h/2, h/4, ...
    ups = [hidden // (2**i) for i in reversed(range(up - 1))]  # ..., h/2, h
    return [ch_in] + downs + ups + [ch_out]


@dataclass(frozen=True)
class GCNStack:
    channels_in: int
    channels_out: int
    hidden_feats: int = 1024  # reference config.json:9
    down_layers: int = 3
    up_layers: int = 3
    compute_dtype: jnp.dtype = jnp.float32
    backend: str = "auto"

    @property
    def widths(self) -> list[int]:
        return _width_schedule(
            self.channels_in, self.hidden_feats, self.channels_out,
            self.down_layers, self.up_layers,
        )

    def init(self, key) -> core.Params:
        widths = self.widths
        keys = jax.random.split(key, len(widths) - 1)
        return {
            f"gcn_{i}": gcn_init(k, widths[i], widths[i + 1])
            for i, k in enumerate(keys)
        }

    def apply(self, params: core.Params, graph, x: Array) -> Array:
        h = x.astype(self.compute_dtype)
        n = len(params)
        for i in range(n):
            h = gcn_apply(params[f"gcn_{i}"], graph, h, backend=self.backend)
            if i < n - 1:  # no activation after the final layer (models_gnn.py:206)
                h = jax.nn.relu(h)
        return h.astype(x.dtype)


@dataclass(frozen=True)
class EncodeProcessDecode:
    """Encoder MLP → K GCN processor steps (residual + LayerNorm) → decoder MLP."""

    channels_in: int
    channels_out: int
    latent_size: int = 256
    process_steps: int = 4
    mlp_layers: int = 2
    residual: bool = True
    compute_dtype: jnp.dtype = jnp.float32
    backend: str = "auto"
    # False | True (full per-step recompute) | "nested:G" (checkpoint
    # GROUPS of G steps with checkpointed inner steps — ceil(S/G) live
    # boundaries instead of S, one extra fwd recompute per step) |
    # "save_agg" (checkpoint the aggregation outputs so the backward never
    # re-runs the sparse aggregation — recompute only elementwise/matmul
    # ops; ~1 extra (N, latent) live tensor per step of memory) |
    # "save_agg:K" (save aggs for only the first K steps, full recompute
    # for the rest — the middle ground when all-steps save_agg overflows
    # device memory; see gwen.train.remat.select_save_agg_steps).
    remat: "bool | str" = False
    # "gcn" (normalized-adjacency aggregation),
    # "interaction" (MeshGraphNets-style edge-MLP messages; segment path),
    # or "attention" (windowed graph attention; diag-window layout).
    processor: str = "gcn"
    attn_heads: int = 2

    def init(self, key) -> core.Params:
        k_enc, k_proc, k_dec = jax.random.split(key, 3)
        L = self.latent_size
        enc_dims = [self.channels_in] + [L] * self.mlp_layers
        dec_dims = [L] * self.mlp_layers + [self.channels_out]
        proc_keys = jax.random.split(k_proc, self.process_steps)
        params: core.Params = {
            "encoder": core.mlp_init(k_enc, enc_dims),
            "decoder": core.mlp_init(k_dec, dec_dims),
        }
        for i, k in enumerate(proc_keys):
            if self.processor == "interaction":
                from gwen.nn.interaction import interaction_init

                params[f"process_{i}"] = interaction_init(k, L, self.mlp_layers)
            elif self.processor == "attention":
                from gwen.nn.attention import graph_attention_init

                params[f"process_{i}"] = {
                    "attn": graph_attention_init(k, L, self.attn_heads),
                    "norm": core.layer_norm_init(L),
                }
            else:
                params[f"process_{i}"] = {
                    "gcn": gcn_init(k, L, L),
                    "norm": core.layer_norm_init(L),
                }
        return params

    def _norm_residual(self, norm_params, m: Array, h: Array) -> Array:
        """Per-step tail ``h + layer_norm(m)`` (float32 statistics); XLA
        fuses the chain into one elementwise/reduction kernel."""
        if self.residual:
            return h + core.layer_norm_apply(norm_params, m)
        return core.layer_norm_apply(norm_params, m)

    def apply(self, params: core.Params, graph, x: Array) -> Array:
        h = x.astype(self.compute_dtype)
        h = core.mlp_apply(params["encoder"], h)

        # Keep node tensors at the graph's padded row count through the
        # process loop: every aggregation then reads them as they are
        # instead of materializing a padded copy of the full (N, latent)
        # state per call. Pad rows carry harmless values through
        # elementwise ops; S has no entries for them.
        pad_rows = 0
        if self.processor == "gcn":
            from gwen.graph.graph import DiagWindowGraph

            if (isinstance(graph, DiagWindowGraph)
                    and h.shape[-2] == graph.num_nodes):
                pad_rows = graph.num_padded_nodes - graph.num_nodes
                if pad_rows > 0:
                    zeros = jnp.zeros(
                        h.shape[:-2] + (pad_rows, h.shape[-1]), h.dtype
                    )
                    h = jnp.concatenate([h, zeros], axis=-2)

        if self.processor == "interaction":
            from gwen.nn.interaction import interaction_apply

            def step(h, p):
                return interaction_apply(p, graph, jax.nn.relu(h))
        elif self.processor == "attention":
            from jax.ad_checkpoint import checkpoint_name

            from gwen.nn.attention import graph_attention_apply
            from gwen.nn.layers import AGG_CKPT_NAME

            def step(h, p):
                m = graph_attention_apply(p["attn"], graph, jax.nn.relu(h),
                                          heads=self.attn_heads)
                m = checkpoint_name(m, AGG_CKPT_NAME)
                return self._norm_residual(p["norm"], m, h)
        else:
            def step(h, p):
                m = gcn_apply(p["gcn"], graph, jax.nn.relu(h), backend=self.backend)
                return self._norm_residual(p["norm"], m, h)

        if isinstance(self.remat, str) and self.remat.startswith("nested"):
            # Two-level remat: checkpoint GROUPS of G steps whose inner
            # steps are themselves checkpointed. Only ceil(S/G) group
            # boundaries stay live across the backward (vs S for
            # remat=True) at the cost of one extra forward recompute per
            # step — for when even remat=True's S boundary states do not
            # fit device memory.
            g = int(self.remat.split(":", 1)[1])
            inner = jax.checkpoint(step, static_argnums=())

            def group(h, ps):
                for p in ps:
                    h = inner(h, p)
                return h

            group_ck = jax.checkpoint(group, static_argnums=())
            for i0 in range(0, self.process_steps, g):
                ps = [params[f"process_{i}"] for i in
                      range(i0, min(i0 + g, self.process_steps))]
                h = group_ck(h, ps)
            if pad_rows > 0:
                h = h[..., : h.shape[-2] - pad_rows, :]
            h = core.mlp_apply(params["decoder"], jax.nn.relu(h))
            return h.astype(x.dtype)

        save_k = None
        if isinstance(self.remat, str) and self.remat.startswith("save_agg"):
            save_k = (self.process_steps if self.remat == "save_agg"
                      else int(self.remat.split(":", 1)[1]))
        if save_k is not None:
            from gwen.nn.layers import AGG_CKPT_NAME

            step_saved = jax.checkpoint(
                step,
                policy=jax.checkpoint_policies.save_only_these_names(
                    AGG_CKPT_NAME),
            )
            step_full = jax.checkpoint(step, static_argnums=())
            per_step = [step_saved if i < save_k else step_full
                        for i in range(self.process_steps)]
        elif self.remat:
            per_step = [jax.checkpoint(step, static_argnums=())] \
                * self.process_steps
        else:
            per_step = [step] * self.process_steps
        for i, st in enumerate(per_step):
            h = st(h, params[f"process_{i}"])
        if pad_rows > 0:
            h = h[..., : h.shape[-2] - pad_rows, :]
        h = core.mlp_apply(params["decoder"], jax.nn.relu(h))
        return h.astype(x.dtype)
