"""The one place that maps the platform JAX runs on to an implementation.

* ``gpu`` — the compiled Triton kernel for the diagonal-window aggregation,
  or the plain-XLA form where the measurement on the card chose it
  (``GPU_DIAG_IMPL``; see PERF.md).
* ``cpu`` — the plain-XLA forms. Pallas kernels run in interpret mode only
  where a caller (a test) passes ``interpret=True`` itself; the platform
  never implies it.
* anything else raises.
"""

from __future__ import annotations

import jax

SUPPORTED = ("gpu", "cpu")

# Diagonal-window aggregation on the GPU: "pallas" (the Triton kernel) or
# "einsum" (gathered-window einsum compiled by XLA), chosen by timing the
# GCN train step on the card.
GPU_DIAG_IMPL = "pallas"

# Windowed attention on the GPU in bf16/fp16: "xla" (masked softmax +
# einsum over gathered windows) or "cudnn" (jax.nn.dot_product_attention
# over the same windows), chosen by timing on the card. cuDNN takes 16-bit
# inputs only; float32 attention always takes the XLA form.
GPU_ATTENTION_IMPL = "cudnn"


def platform() -> str:
    """The default backend's platform, checked against what the program
    supports."""
    plat = jax.default_backend()
    if plat not in SUPPORTED:
        raise RuntimeError(
            f"unsupported platform {plat!r}; this program runs on "
            f"{' or '.join(SUPPORTED)}"
        )
    return plat


def diag_impl(backend: str = "auto") -> str:
    """Implementation of the diagonal-window aggregation: ``"pallas"`` or
    ``"einsum"``. ``backend="auto"`` asks the platform; ``"pallas"`` forces
    the kernel; any other value means the plain-XLA form."""
    if backend == "auto":
        return GPU_DIAG_IMPL if platform() == "gpu" else "einsum"
    return "pallas" if backend == "pallas" else "einsum"


def attention_impl(dtype) -> str:
    """Implementation of the windowed attention for inputs of ``dtype``:
    ``"xla"`` or ``"cudnn"``."""
    import jax.numpy as jnp

    half = jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
    return GPU_ATTENTION_IMPL if platform() == "gpu" and half else "xla"
