"""Member-graph GNN benchmark at reference scale.

The reference's actual headline workload (SURVEY §3.3): ~125 ensemble-member
nodes, fully connected, node features = flattened ``height × ncells`` field,
``hidden_feats=1024`` — conv1's ``(features, 1024)`` weight dominates FLOPs.
The member graph densifies to a 125×125 adjacency and every GCN layer is
two dense matmuls.

Prints one JSON line with the full-train-step time and achieved model FLOP/s.

Env knobs: GWEN_MB_MEMBERS (125), GWEN_MB_FEATURES (65536 ≈ 64 levels × 1024
cells), GWEN_MB_HIDDEN (1024), GWEN_MB_BATCH (4), GWEN_MB_ITERS (20).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from gwen.compile_cache import enable_compile_cache

    enable_compile_cache()

    from gwen.graph import build_graph, complete_edges, to_dense
    from gwen.nn import GCNStack
    from gwen.train import TrainState, gnn_loss_fn

    members = int(os.environ.get("GWEN_MB_MEMBERS", "125"))
    feats = int(os.environ.get("GWEN_MB_FEATURES", "65536"))
    hidden = int(os.environ.get("GWEN_MB_HIDDEN", "1024"))
    batch = int(os.environ.get("GWEN_MB_BATCH", "4"))
    iters = int(os.environ.get("GWEN_MB_ITERS", "20"))

    s, r = complete_edges(members)
    graph = to_dense(build_graph(s, r, members))
    model = GCNStack(
        channels_in=feats, channels_out=feats, hidden_feats=hidden,
        compute_dtype=jnp.bfloat16,
    )
    params = model.init(jax.random.key(0))
    opt = optax.adam(1e-4)
    state = TrainState.create(params, opt)

    x = jax.random.normal(jax.random.key(1), (batch, members, feats), jnp.float32)
    mask = jnp.zeros((members,), bool).at[members - 1 :].set(True)
    batch_data = {"x": x, "mask": mask}

    # On-device scan chain + difference-method readout (see
    # gwen.profiling.scan_timeit): fixed dispatch costs cancel.
    from gwen.profiling import scan_timeit

    loss_fn = gnn_loss_fn(model, graph)

    def train_step(st, bd):
        def loss(p):
            return loss_fn(p, bd)[0]

        lval, grads = jax.value_and_grad(loss)(st.params)
        updates, opt_state = opt.update(grads, st.opt_state, st.params)
        return TrainState(params=optax.apply_updates(st.params, updates),
                          opt_state=opt_state, step=st.step + 1)

    dt = scan_timeit(train_step, state, batch_data, iters=iters)["mean_s"]

    # Sanity: one real step must produce a finite loss — a silently
    # diverging/NaN configuration should fail the benchmark, not report a
    # timing number.
    loss_val = float(loss_fn(state.params, batch_data)[0])
    assert jnp.isfinite(loss_val), f"non-finite train loss: {loss_val}"

    # Model FLOPs per step: fwd+bwd ≈ 3x fwd; fwd = per-layer 2*B*M*(din*dout)
    widths = model.widths
    fwd_flops = sum(
        2 * batch * members * widths[i] * widths[i + 1] for i in range(len(widths) - 1)
    )
    flops = 3 * fwd_flops
    print(json.dumps({
        "metric": "member_gnn_train_step_ms",
        "members": members, "features": feats, "hidden": hidden, "batch": batch,
        "value": round(dt * 1e3, 3), "unit": "ms",
        "model_tflops_per_s": round(flops / dt / 1e12, 2),
    }))


if __name__ == "__main__":
    main()
