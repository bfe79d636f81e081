"""UNet CNN baseline.

Reference parity: ``models_cnn.py:86-460`` — ``BaseNet`` layer zoo (5 Conv2d,
4 ConvTranspose2d, 4 BatchNorm2d, maxpool, bilinear upsample), ``Encoder`` =
4×(conv→maxpool→norm→ReLU) returning all four scales, ``Decoder`` =
4×(convT→upsample→norm→ReLU) with crop-and-concat skip connections
(models_cnn.py:272-300) and padding fixups (models_cnn.py:372,449-452).

Deviations (documented, deliberate):

* ``lax.conv_general_dilated`` with bilinear ``jax.image.resize`` upsampling
  (resize+conv instead of ConvTranspose2d — equivalent capacity, avoids
  checkerboard artifacts); XLA hands the convs to its own or cuDNN's
  kernels (SURVEY §2.2 row "cuDNN/cuBLAS").
* GroupNorm instead of BatchNorm2d: stateless and SPMD-friendly — BatchNorm
  needs cross-replica batch-stat sync (extra collectives every step) and
  mutable running stats; GroupNorm gives the same normalization role with
  none of that.
* Arbitrary spatial sizes handled by edge-padding up to a multiple of
  ``2^depth`` on the way in and cropping on the way out, instead of the
  reference's per-layer crop/replicate-pad fixups.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from gwen.nn import core

Array = jnp.ndarray


def conv_init(key, c_in: int, c_out: int, k: int = 3) -> core.Params:
    fan_in = c_in * k * k
    w = jax.random.normal(key, (c_out, c_in, k, k)) * jnp.sqrt(2.0 / fan_in)
    return {"w": w, "b": jnp.zeros((c_out,))}


def conv_apply(p: core.Params, x: Array, stride: int = 1) -> Array:
    w = p["w"].astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        x, w,
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=x.dtype,
    )
    return out + p["b"].astype(x.dtype)[None, :, None, None]


def group_norm_init(channels: int) -> core.Params:
    return {"scale": jnp.ones((channels,)), "bias": jnp.zeros((channels,))}


def group_norm_apply(p: core.Params, x: Array, groups: int = 8, eps: float = 1e-5) -> Array:
    n, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.astype(jnp.float32).reshape(n, g, c // g, h, w)
    mean = xf.mean(axis=(2, 3, 4), keepdims=True)
    var = xf.var(axis=(2, 3, 4), keepdims=True)
    xf = (xf - mean) * jax.lax.rsqrt(var + eps)
    xf = xf.reshape(n, c, h, w)
    out = xf * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]
    return out.astype(x.dtype)


def max_pool(x: Array, k: int = 2) -> Array:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, k, k), (1, 1, k, k), "VALID"
    )


@dataclass(frozen=True)
class UNet:
    """4-scale UNet: ``channels_in`` member-channels → ``channels_out``."""

    channels_in: int
    channels_out: int
    hidden: int = 64
    depth: int = 4
    compute_dtype: jnp.dtype = jnp.float32

    def _widths(self) -> list[int]:
        return [self.hidden * (2**i) for i in range(self.depth)]

    def init(self, key) -> core.Params:
        widths = self._widths()
        keys = jax.random.split(key, 2 * self.depth + 1)
        params: core.Params = {}
        c = self.channels_in
        for i, w in enumerate(widths):  # encoder
            params[f"enc_{i}"] = {
                "conv": conv_init(keys[i], c, w),
                "norm": group_norm_init(w),
            }
            c = w
        for i in range(self.depth):  # decoder (reverse widths)
            # After upsampling, h sits at the scale of encoder skip
            # depth-1-i; concat it (crop-and-concat, models_cnn.py:272-300).
            skip_ch = widths[self.depth - 1 - i]
            w_out = widths[self.depth - 2 - i] if i < self.depth - 1 else self.hidden
            params[f"dec_{i}"] = {
                "conv": conv_init(keys[self.depth + i], c + skip_ch, w_out),
                "norm": group_norm_init(w_out),
            }
            c = w_out
        params["head"] = conv_init(keys[-1], self.hidden, self.channels_out, k=1)
        return params

    def apply(self, params: core.Params, x: Array) -> Array:
        orig_dtype = x.dtype
        h0, w0 = x.shape[-2:]
        m = 2**self.depth
        pad_h = (-h0) % m
        pad_w = (-w0) % m
        x = jnp.pad(x, ((0, 0), (0, 0), (0, pad_h), (0, pad_w)), mode="edge")
        h = x.astype(self.compute_dtype)

        skips = []
        for i in range(self.depth):  # encoder: conv→pool→norm→relu (models_cnn.py:186-253)
            p = params[f"enc_{i}"]
            h = conv_apply(p["conv"], h)
            skips.append(h)
            h = max_pool(h)
            h = group_norm_apply(p["norm"], h)
            h = jax.nn.relu(h)

        for i in range(self.depth):  # decoder: upsample→concat-skip→conv→norm→relu
            p = params[f"dec_{i}"]
            n, c, hh, ww = h.shape
            h = jax.image.resize(h, (n, c, hh * 2, ww * 2), method="bilinear")
            skip = skips[self.depth - 1 - i]  # same spatial scale as h now
            h = jnp.concatenate([h, skip.astype(h.dtype)], axis=1)
            h = conv_apply(p["conv"], h)
            h = group_norm_apply(p["norm"], h)
            h = jax.nn.relu(h)

        out = conv_apply(params["head"], h)
        out = out[..., :h0, :w0]
        return out.astype(orig_dtype)
