"""Quickest end-to-end proof that the system runs on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the partitioned path only

Phases (one card), each printing one diagnostic line with its wall time,
the card's name and power limit, and the device's peak bytes in use:

1. device   — the default JAX device must be a GPU; anything else exits
               non-zero before any work.
2. goldens  — every translated kernel against the plain reference at a real
               width (L7 icosphere, F=256, batch 1 and 4): the diagonal-window
               aggregation (Triton kernel) forward and gradient against
               ``segment_sum``, the residual LayerNorm against a float64
               host reference, the windowed attention (XLA form and cuDNN)
               against an edge-list masked softmax.
3. gcn      — ``train-mesh`` with the GCN processor at the full model width
               (latent 256, 4 process steps, 2-layer MLPs, bfloat16) on the
               L8 icosphere (655,362 nodes) for a few optimizer steps.
4. serving  — ``export`` of that run, then ``predict --steps 4`` from x0.npy.
5. attention— ``train-mesh`` with the attention processor (2 heads, latent
               256) at L7.

``--four-cards`` runs ``train-mesh`` at L8 with ``mesh.graph_axis=4`` and the
diag partition layout, then compares one step's loss and gradient norm of
the partitioned model with the single-device global model on the same
params and batch, and prints every card's bytes in use.

Everything runs in this one process through ``gwen.cli.main.main``; a
failing phase raises and the script exits non-zero. The last line of
standard output is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# The aggregation goldens compare against segment_sum in float32 at
# "highest" matmul precision. Float32 inputs: a float32 product on this card
# defaults to one TF32 pass (10 mantissa bits, ~5e-4 relative error), so
# the kernel takes a three-pass TF32 product (about float32 accuracy) and
# the two differ by little more than summation order: 1e-5 of the output
# scale. bfloat16 inputs: the inputs and S carry 8 mantissa bits (rounding
# error ~2^-9 each, accumulated over ~7 neighbours in float32): 2e-2.
AGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Residual LayerNorm in float32 against a float64 host computation.
LN_TOL = 1e-5
# Attention in bfloat16 (q, k, v and the probabilities rounded to bf16)
# against a float32 edge-list softmax, relative to the output scale; the
# same bound for the gradients of q, k and v, whose reference takes the
# bf16-rounded inputs (the backward rounds the cotangent and probabilities
# to bf16 once more).
ATTN_TOL = 2e-2
# The windowed-attention forms compared on the card (the XLA form and
# cuDNN's fused attention, the GPU's choice for 16-bit inputs).
ATTN_IMPLS = ("xla", "cudnn")
# Icosphere levels: goldens and attention at L7 (163,842 nodes), GCN
# training and serving at L8 (655,362 nodes).
GOLDEN_LEVEL, GCN_LEVEL, ATTN_LEVEL = 7, 8, 7


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def device_check() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        sys.exit(2)


def device_bytes(key: str) -> list[int]:
    """``memory_stats()[key]`` of every device."""
    import jax

    return [int(d.memory_stats()[key]) for d in jax.devices()]


def peak_bytes() -> int:
    return device_bytes("peak_bytes_in_use")[0]


def report(phase: str, t0: float, card_name: str, **fields) -> None:
    line = {"phase": phase, "ok": True,
            "wall_s": round(time.perf_counter() - t0, 3),
            "card": card_name, "peak_bytes_in_use": peak_bytes(), **fields}
    print(json.dumps(line), flush=True)


def cli(argv: list[str]) -> dict:
    """Run one CLI command in this process; return its JSON result."""
    from gwen.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} returned {rc}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def rel_err(got, ref) -> float:
    import jax.numpy as jnp

    got = jnp.asarray(got, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    return float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))


def check(name: str, err: float, tol: float, results: dict) -> None:
    results[name] = err
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} > tolerance {tol:.0e}")


def mesh_graph(level: int):
    from gwen.graph import (apply_order, build_graph, icosphere_edges,
                                kd_patch_order)

    verts, s, r = icosphere_edges(level)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n)
    s, r, _ = apply_order(perm, s, r)
    return build_graph(s, r, n), n


def goldens(card_name: str) -> None:
    import jax
    import jax.numpy as jnp

    from gwen.graph import to_diag_window
    from gwen.nn import EncodeProcessDecode
    from gwen.ops.aggregate import aggregate_segment
    from gwen.ops.spmm_pallas import spmm_diag_window

    t0 = time.perf_counter()
    g, n = mesh_graph(GOLDEN_LEVEL)
    f = 256
    res: dict = {}
    # Graph tables are jit arguments, never closed-over constants.
    g_d = jax.device_put(g)
    seg = jax.jit(aggregate_segment)
    seg_grad = jax.jit(jax.grad(
        lambda x, gr: jnp.sum(jnp.sin(aggregate_segment(gr, x)))))
    kern = jax.jit(spmm_diag_window)
    kern_grad = jax.jit(jax.grad(lambda x, gr: jnp.sum(jnp.sin(
        spmm_diag_window(gr, x).astype(jnp.float32)))))
    for dtype in ("float32", "bfloat16"):
        dw = jax.device_put(to_diag_window(
            g, window_size=384, dtype=getattr(jnp, dtype), device_build=True))
        for batch in (1, 4):
            x = jax.random.normal(jax.random.key(batch), (batch, n, f),
                                  jnp.float32)
            with jax.default_matmul_precision("highest"):
                ref, gref = seg(g_d, x), seg_grad(x, g_d)
            xd = x.astype(dtype)
            check(f"agg_fwd_{dtype}_b{batch}", rel_err(kern(dw, xd), ref),
                  AGG_TOL[dtype], res)
            check(f"agg_grad_{dtype}_b{batch}",
                  rel_err(kern_grad(xd, dw), gref), AGG_TOL[dtype], res)

    model = EncodeProcessDecode(channels_in=4, channels_out=4,
                                latent_size=f)
    norm = {"scale": 1.0 + 0.1 * jax.random.normal(jax.random.key(5), (f,)),
            "bias": 0.1 * jax.random.normal(jax.random.key(6), (f,))}
    m = jax.random.normal(jax.random.key(7), (4, n, f), jnp.float32)
    h = jax.random.normal(jax.random.key(8), (4, n, f), jnp.float32)
    got = jax.jit(model._norm_residual)(norm, m, h)
    m64, h64 = np.asarray(m, np.float64), np.asarray(h, np.float64)
    mu = m64.mean(-1, keepdims=True)
    var = m64.var(-1, keepdims=True)
    want = (h64 + (m64 - mu) / np.sqrt(var + 1e-6)
            * np.asarray(norm["scale"], np.float64)
            + np.asarray(norm["bias"], np.float64))
    ln_err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    check("layernorm_f32", ln_err, LN_TOL, res)

    attention_goldens(g, n, f, res)
    report("goldens", t0, card_name, errors=res)


def attention_goldens(g, n: int, f: int, res: dict) -> None:
    """Windowed attention (2 heads of f/2) forward and gradient against the
    edge-list reference, for every form in ``ATTN_IMPLS``. The gradient runs
    over all S rows: the rows past the last node have no neighbour, so their
    outputs and every gradient there must be zero (and finite)."""
    import jax
    import jax.numpy as jnp

    from gwen.graph import to_diag_window
    from gwen.ops.attention import (edge_attention_reference,
                                    window_edges, windowed_attention)

    dw = jax.device_put(to_diag_window(g, window_size=384,
                                       dtype=jnp.bfloat16, device_build=True))
    es, er = window_edges(dw)
    rows = dw.s_mat.shape[0]
    ref_fn = jax.jit(edge_attention_reference, static_argnums=(5,))

    def grads(fn):
        """d/d(q, k, v) of sum(fn(q, k, v, *tables) * ct); graph tables are
        jit arguments, never closed-over constants."""
        def loss(q, k, v, ct, *tables):
            return jnp.sum(fn(q, k, v, *tables).astype(jnp.float32) * ct)
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))

    ref_grad = grads(lambda q, k, v, es, er: edge_attention_reference(
        es, er, q, k, v, rows))
    for batch in (1, 4):
        keys = jax.random.split(jax.random.key(10 + batch), 4)
        q, k, v, ct = (jax.random.normal(kk, (2, batch, rows, f // 2),
                                         jnp.float32) for kk in keys)
        qb, kb, vb = (a.astype(jnp.bfloat16) for a in (q, k, v))
        ref = ref_fn(es, er, q[..., :n, :], k[..., :n, :], v[..., :n, :], n)
        gref = ref_grad(*(a.astype(jnp.float32) for a in (qb, kb, vb)), ct,
                        es, er)
        for impl in ATTN_IMPLS:
            fwd = functools.partial(windowed_attention, impl=impl)
            got = jax.jit(fwd)(dw, qb[..., :n, :], kb[..., :n, :],
                               vb[..., :n, :])
            check(f"attention_{impl}_bf16_b{batch}", rel_err(got, ref),
                  ATTN_TOL, res)
            ggot = grads(lambda q, k, v, dw: fwd(dw, q, k, v))(
                qb, kb, vb, ct, dw)
            for name, a, b in zip("qkv", ggot, gref):
                check(f"attention_{impl}_bf16_b{batch}_d{name}",
                      rel_err(a, b), ATTN_TOL, res)
                check(f"attention_{impl}_bf16_b{batch}_d{name}_padded_rows",
                      float(jnp.max(jnp.abs(
                          a[..., n:, :].astype(jnp.float32)))), 0.0, res)


def train_mesh(level: int, processor: str, root: Path, extra=()) -> dict:
    return cli([
        "train-mesh", "--members", "2", "--steps", "7",
        f"graph.refine={level}", f"model.processor={processor}",
        "model.latent_size=256", "model.process_steps=4",
        "model.mlp_layers=2", "model.attn_heads=2",
        "model.compute_dtype=bfloat16", "train.batch_size=2",
        "train.epochs=1", "train.log_every=1",
        f"run.registry_root={root}", "run.experiment=SMOKE",
        *extra,
    ])


def check_train(out: dict) -> None:
    if not out["train_steps"] or not out["train_losses_finite"]:
        raise AssertionError(
            f"{out['train_steps']} train steps, finite losses: "
            f"{out['train_losses_finite']}")


def gcn_and_serving(card_name: str, root: Path) -> None:
    t0 = time.perf_counter()
    out = train_mesh(GCN_LEVEL, "gcn", root)
    check_train(out)
    if out["layout"] != "diag":
        raise AssertionError(f"GCN ran on the {out['layout']} layout")
    report("gcn", t0, card_name, nodes=out["nodes"],
           steps=out["train_steps"], last_loss=out["train_loss_last"],
           train_step_memory=out["train_step_memory"])

    t0 = time.perf_counter()
    art = root / "artifact"
    exp = cli(["export", "--out", str(art), f"run.registry_root={root}",
               "run.experiment=SMOKE"])
    n, ch = exp["nodes"], exp["channels"]
    x0 = np.random.default_rng(0).normal(size=(n, ch)).astype(np.float32)
    np.save(root / "x0.npy", x0)
    pred = cli(["predict", "--artifact", str(art), "--input",
                str(root / "x0.npy"), "--steps", "4",
                "--out", str(root / "pred.npy")])
    traj = np.load(root / "pred.npy")
    if traj.shape != (4, n, ch) or not np.all(np.isfinite(traj)):
        raise AssertionError(
            f"predicted trajectory {traj.shape}, finite="
            f"{bool(np.all(np.isfinite(traj)))}; want (4, {n}, {ch})")
    report("serving", t0, card_name, platform=exp["platform"],
           shape=pred["shape"])


def attention(card_name: str, root: Path) -> None:
    t0 = time.perf_counter()
    out = train_mesh(ATTN_LEVEL, "attention", root / "attn")
    check_train(out)
    report("attention", t0, card_name, nodes=out["nodes"],
           steps=out["train_steps"], last_loss=out["train_loss_last"],
           train_step_memory=out["train_step_memory"])


def four_cards(card_name: str, root: Path) -> None:
    """The partitioned (data, graph) path on four cards and its comparison
    with the single-device global model."""
    import jax
    import jax.numpy as jnp

    from gwen.graph import to_diag_window
    from gwen.nn import EncodeProcessDecode
    from gwen.parallel import make_partitioned_apply, partition_graph
    from gwen.train import make_mesh

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found "
                           f"{len(jax.devices())}")
    t0 = time.perf_counter()
    out = train_mesh(GCN_LEVEL, "gcn", root, extra=("mesh.graph_axis=4",
                                            "mesh.partition_layout=diag"))
    check_train(out)
    report("train_mesh_graph_axis_4", t0, card_name, nodes=out["nodes"],
           steps=out["train_steps"], last_loss=out["train_loss_last"],
           train_step_memory=out["train_step_memory"],
           bytes_in_use=device_bytes("bytes_in_use"))

    t0 = time.perf_counter()
    g, n = mesh_graph(GCN_LEVEL)
    s = np.asarray(g.senders)[: g.num_edges]
    r = np.asarray(g.receivers)[: g.num_edges]
    keep = s != r  # partition_graph adds the self loops itself
    pg = partition_graph(s[keep], r[keep], n, num_parts=4, reorder=False,
                         layout="diag", diag_window=384, device_build=True)
    mesh = make_mesh(data=1, graph=4)
    model = EncodeProcessDecode(channels_in=4, channels_out=4,
                                latent_size=256, process_steps=4)
    params = model.init(jax.random.key(0))
    apply_p = make_partitioned_apply(model, pg, mesh)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, n, 4)).astype(np.float32)
    y = rng.normal(size=(2, n, 4)).astype(np.float32)

    # Graph tables and data are jit arguments, never closed-over constants.
    def loss_p(p, xp, yp, tables):
        pred = apply_p(p, xp, tables)[:, :n]
        return jnp.mean((pred - yp[:, :n]) ** 2)

    def loss_g(p, x, y, dw):
        return jnp.mean((model.apply(p, dw, x) - y) ** 2)

    dw = jax.device_put(to_diag_window(g, window_size=384, device_build=True),
                        jax.devices()[0])

    def gnorm(grads):
        return float(jnp.sqrt(sum(jnp.sum(jnp.square(t)) for t in
                                  jax.tree_util.tree_leaves(grads))))

    with jax.default_matmul_precision("highest"):
        lp, gp = jax.jit(jax.value_and_grad(loss_p))(
            params, pg.pad_nodes(x), pg.pad_nodes(y), apply_p.tables)
        lg, gg = jax.jit(jax.value_and_grad(loss_g))(params, x, y, dw)
    res = {"loss_partitioned": float(lp), "loss_global": float(lg),
           "grad_norm_partitioned": gnorm(gp), "grad_norm_global": gnorm(gg)}
    # float32 throughout; the two sum the same terms in another order.
    check("loss_rel", abs(res["loss_partitioned"] - res["loss_global"])
          / abs(res["loss_global"]), 1e-4, res)
    check("grad_norm_rel", abs(res["grad_norm_partitioned"]
                               - res["grad_norm_global"])
          / res["grad_norm_global"], 1e-3, res)
    report("partitioned_vs_global", t0, card_name, **res,
           bytes_in_use=device_bytes("bytes_in_use"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the partitioned path on four cards")
    args = parser.parse_args()

    t0 = time.perf_counter()
    device_check()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from gwen.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    card_name = card()
    print(f"card: {card_name}", flush=True)
    report("device", t0, card_name, devices=len(jax.devices()),
           kind=jax.devices()[0].device_kind)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        if args.four_cards:
            four_cards(card_name, root)
        else:
            goldens(card_name)
            gcn_and_serving(card_name, root)
            attention(card_name, root)
    dev = jax.devices()[0]
    print(f"card: {card_name}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
