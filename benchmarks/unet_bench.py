"""UNet CNN smoke bench on the GPU (one JSON line).

The reference's CNN path was its *complete* DDP story
(models_cnn.py:462-565); this framework's UNet runs on XLA's own convs
(`lax.conv_general_dilated`, SURVEY §2.2 "no custom kernel needed"). This
bench times a reference-config UNet (124 member-channels → 1, hidden 64,
depth 4, bf16 compute) forward + train step with the on-device scan-chain
harness (``gwen.profiling.scan_timeit``).

    GWEN_UNET_SHAPE=8,124,128,256 python benchmarks/unet_bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from gwen.compile_cache import enable_compile_cache

    enable_compile_cache()

    from gwen.nn.unet import UNet
    from gwen.profiling import scan_timeit
    from gwen.train import TrainState

    shape = tuple(int(v) for v in os.environ.get(
        "GWEN_UNET_SHAPE", "8,124,128,256").split(","))
    iters = int(os.environ.get("GWEN_UNET_ITERS", "20"))
    b, c, h, w = shape

    model = UNet(channels_in=c, channels_out=1, hidden=64, depth=4,
                 compute_dtype=jnp.bfloat16)
    params = model.init(jax.random.key(0))
    opt = optax.adam(1e-4)
    state = TrainState.create(params, opt)

    x = jax.random.normal(jax.random.key(1), shape, jnp.bfloat16)
    y = jnp.mean(x, axis=1, keepdims=True)

    def train_step(st, xx, yy):
        def loss(p):
            pred = model.apply(p, xx)
            return jnp.mean(jnp.abs(pred - yy.astype(pred.dtype)))

        lval, grads = jax.value_and_grad(loss)(st.params)
        updates, opt_state = opt.update(grads, st.opt_state, st.params)
        return TrainState(params=optax.apply_updates(st.params, updates),
                          opt_state=opt_state, step=st.step + 1)

    # scan_timeit chains the first argument as the carry — fold the
    # (B, 1, H, W) prediction back into the (B, C, H, W) input shape via a
    # broadcast add (one elementwise pass, trivial next to the convs).
    t_fwd = scan_timeit(
        lambda xx, p: (xx * 0.99 + model.apply(p, xx)).astype(xx.dtype),
        x, state.params, iters=iters)["mean_s"]
    t_step = scan_timeit(train_step, state, x, y, iters=iters)["mean_s"]
    px = b * h * w
    print(json.dumps({
        "metric": "unet_train_step_ms",
        "shape": list(shape),
        "hidden": 64, "depth": 4, "dtype": "bfloat16",
        "fwd_ms": round(t_fwd * 1e3, 3),
        "train_step_ms": round(t_step * 1e3, 3),
        "pixels_per_s_train": round(px / t_step, 1),
        "backend": jax.default_backend(),
        "ts": time.time(),
    }), flush=True)


if __name__ == "__main__":
    main()
