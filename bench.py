"""Benchmark: the diagonal-window aggregation and the GCN train step on a GPU.

    python bench.py            # L8 icosphere, F=256, bf16, batch 2

Times, on the card, end to end with ``block_until_ready``:

* the aggregation forward+backward of one (batch, N, F) tensor through the
  Triton kernel (``pallas``), its plain-XLA form (``einsum``, gathered
  windows) and receiver-sorted ``segment_sum`` on the COO graph;
* the full GCN train step (EncodeProcessDecode, latent 256, 4 process
  steps, 2-layer MLPs, bf16, adam) with each of the three aggregations;
* the windowed attention forward+backward at L7 (2 heads of 128) through the
  XLA form and through cuDNN's fused attention over the same windows;
* forward parts: the kernel's in-window core, the escape composite, and the
  residual LayerNorm of one process step (with its bytes per second for
  two reads and one write);
* the host-side build of the L8 mesh tables (icosphere, KD ordering, COO
  graph, diag tables), as set-up time.

Variants run in turns (A, B, C, C, B, A) and each reports the mean of its
two turns. Prints one JSON line with the numbers and the device
(``platform``, ``device_kind``, ``count``) plus the card's name and power
limit; exits non-zero without a GPU. Env knobs: GWEN_BENCH_LEVELS (8),
GWEN_BENCH_ATTN_LEVELS (7), GWEN_BENCH_FEATURES (256), GWEN_BENCH_BATCH (2),
GWEN_BENCH_ITERS (10).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def _mesh(levels: int):
    from gwen.graph import (apply_order, build_graph, icosphere_edges,
                                kd_patch_order)

    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n)
    s, r, _ = apply_order(perm, s, r)
    return build_graph(s, r, n), n


def _time_ms(fn, args, iters: int, feed: bool) -> float:
    """Mean wall time of ``fn(*args)`` over ``iters`` calls after a warm-up
    call; with ``feed`` the first result replaces the first argument (the
    train state of a train step)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        if feed:
            args = (out[0],) + tuple(args[1:])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def _turns(variants: dict, iters: int) -> dict:
    """Run variants in turns A B C C B A; mean ms per variant."""
    names = list(variants)
    times: dict = {k: [] for k in names}
    for k in names + names[::-1]:
        fn, args, feed = variants[k]
        times[k].append(_time_ms(fn, args, iters, feed))
    return {k: float(np.mean(v)) for k, v in times.items()}


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench: needs a GPU", file=sys.stderr)
        return 2
    from gwen.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import optax

    from gwen.graph import to_diag_window
    from gwen.nn import EncodeProcessDecode
    from gwen.ops.aggregate import (aggregate_diag_window_reference,
                                        aggregate_segment)
    from gwen.ops.attention import windowed_attention
    from gwen.ops.spmm_pallas import spmm_diag_window

    levels = int(os.environ.get("GWEN_BENCH_LEVELS", "8"))
    attn_levels = int(os.environ.get("GWEN_BENCH_ATTN_LEVELS", "7"))
    feats = int(os.environ.get("GWEN_BENCH_FEATURES", "256"))
    batch = int(os.environ.get("GWEN_BENCH_BATCH", "2"))
    iters = int(os.environ.get("GWEN_BENCH_ITERS", "10"))
    dev = jax.devices()[0]
    out: dict = {"platform": dev.platform, "device_kind": dev.device_kind,
                 "count": len(jax.devices()), "card": _card(),
                 "levels": levels, "features": feats, "batch": batch}

    t0 = time.perf_counter()
    g, n = _mesh(levels)
    dw = to_diag_window(g, window_size=384, dtype=jnp.bfloat16,
                        device_build=True)
    jax.block_until_ready(dw.s_mat)
    out["host_build_s"] = time.perf_counter() - t0
    dw = jax.device_put(dw)
    gc = jax.device_put(g)
    out.update(nodes=n, edges=g.num_edges,
               escapes=dw.escape.num_edges if dw.escape else 0)
    x = jax.random.normal(jax.random.key(0), (batch, n, feats),
                          jnp.float32).astype(jnp.bfloat16)

    # Graph tables are jit arguments, never closed-over constants.
    def agg_fb(agg):
        return jax.jit(jax.value_and_grad(
            lambda x, gr: jnp.sum(agg(gr, x).astype(jnp.float32) ** 2)))

    out["agg_fwd_bwd_ms"] = _turns({
        "pallas": (agg_fb(spmm_diag_window), (x, dw), False),
        "einsum": (agg_fb(aggregate_diag_window_reference), (x, dw), False),
        "segment": (agg_fb(aggregate_segment), (x, gc), False),
    }, iters)

    from gwen.ops.aggregate import escape_add
    from gwen.ops.spmm_pallas import diag_window_core

    core = jax.jit(lambda x, gr: diag_window_core(
        gr.xbase, gr.offsets, gr.s_mat, x, superblock=gr.superblock,
        src_rows=gr.num_src_rows))
    esc = jax.jit(lambda x, gr: escape_add(gr, x, jnp.zeros_like(x)))
    model = EncodeProcessDecode(channels_in=feats, channels_out=feats,
                                latent_size=feats)
    norm = {"scale": jnp.ones((feats,)), "bias": jnp.zeros((feats,))}
    ln = jax.jit(model._norm_residual)
    h = (x * 0.5).astype(x.dtype)  # a second array: two reads, one write
    parts = _turns({
        "kernel_core": (core, (x, dw), False),
        "escapes": (esc, (x, dw), False),
        "residual_layernorm": (ln, (norm, x, h), False),
    }, iters)
    out["forward_parts_ms"] = parts
    out["residual_layernorm_gbytes_per_s"] = (
        3 * x.size * x.dtype.itemsize / (parts["residual_layernorm"] * 1e-3)
        / 1e9)

    opt = optax.adam(1e-4)
    y = jnp.zeros((batch, n, feats), jnp.float32)

    def train_step(backend, graph):
        model = EncodeProcessDecode(
            channels_in=feats, channels_out=feats, latent_size=256,
            process_steps=4, mlp_layers=2, compute_dtype=jnp.bfloat16,
            backend=backend)
        params = model.init(jax.random.key(0))

        @jax.jit
        def step(state, x, graph):
            p, o = state

            def loss(p):
                return jnp.mean((model.apply(p, graph, x) - y) ** 2)

            lval, grads = jax.value_and_grad(loss)(p)
            upd, o = opt.update(grads, o, p)
            return (optax.apply_updates(p, upd), o), lval

        return step, ((params, opt.init(params)), x, graph), True

    out["gcn_train_step_ms"] = _turns({
        "pallas": train_step("pallas", dw),
        "einsum": train_step("einsum", dw),
        "segment": train_step("segment", gc),
    }, iters)

    ga, na = _mesh(attn_levels)
    dwa = jax.device_put(to_diag_window(ga, window_size=384,
                                        dtype=jnp.bfloat16,
                                        device_build=True))
    qkv = [jax.random.normal(k, (2, batch, na, 128), jnp.float32)
           .astype(jnp.bfloat16)
           for k in jax.random.split(jax.random.key(1), 3)]

    def attn_fb(impl):
        return jax.jit(jax.value_and_grad(
            lambda q, k, v, gr: jnp.sum(windowed_attention(
                gr, q, k, v, impl=impl).astype(jnp.float32) ** 2),
            argnums=(0, 1, 2)))

    out["attention_nodes"] = na
    out["attention_fwd_bwd_ms"] = _turns({
        "xla": (attn_fb("xla"), (*qkv, dwa), False),
        "cudnn": (attn_fb("cudnn"), (*qkv, dwa), False),
    }, iters)
    out["peak_bytes_in_use"] = int(dev.memory_stats()["peak_bytes_in_use"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
