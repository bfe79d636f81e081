"""Ensemble-member perturbation sampling and skill verification.

North-star machinery (BASELINE.json): generate additional ensemble members by
perturbing initial conditions on the member axis with PRNG-keyed,
graph-correlated noise, roll the model forward, and score the generated
ensemble against held-out members with proper scores (fair ensemble CRPS,
RMSE of the ensemble mean, spread/skill ratio). The reference only *selects*
members (target_mask); it never samples new ones — this is the extension the
new framework exists for.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from gwen import losses
from gwen.ops.aggregate import aggregate

Array = jnp.ndarray


def correlated_noise(
    key,
    graph,
    shape: tuple[int, ...],
    smoothing_steps: int = 2,
    dtype=jnp.float32,
) -> Array:
    """Spatially-correlated field noise: white noise smoothed by repeated
    normalized-adjacency aggregation over the mesh graph. ``shape`` is
    ``(..., nodes, channels)``; smoothing acts on the node axis."""
    eps = jax.random.normal(key, shape, dtype)
    for _ in range(smoothing_steps):
        eps = aggregate(graph, eps)
    # Restore unit variance after smoothing.
    std = jnp.std(eps, axis=(-2, -1), keepdims=True) + 1e-8
    return eps / std


def sample_perturbed_members(
    key,
    base_state: Array,
    num_members: int,
    sigma: float = 0.1,
    graph=None,
    smoothing_steps: int = 2,
    batch_dims: int = 0,
) -> Array:
    """K perturbed initial conditions from one base state.

    ``base_state``: (nodes, channels) → returns (K, nodes, channels); with
    ``batch_dims=d``, the member axis is inserted *after* the first ``d``
    leading batch axes (``(B, N, C)`` → ``(B, K, N, C)``), which is the
    layout the CRPS-ensemble loss fns consume. With a graph, noise is
    spatially correlated (physically plausible perturbations); without,
    white.

    The member axis rides the batch-native aggregation as a leading dim
    (one kernel call for all members) rather than ``jax.vmap``.

    RNG-stream note (round-4 change): members are drawn as ONE
    ``(..., K, ...)`` normal tensor rather than K per-member split keys —
    the distribution is identical, but re-running a pre-round-4 experiment
    with the same PRNG key produces different (equally valid) members.
    """
    shape = (base_state.shape[:batch_dims] + (num_members,)
             + base_state.shape[batch_dims:])
    if graph is not None:
        eps = correlated_noise(key, graph, shape, smoothing_steps,
                               base_state.dtype)
    else:
        eps = jax.random.normal(key, shape, base_state.dtype)
    base = jnp.expand_dims(base_state, batch_dims)
    return base + jnp.asarray(sigma, base_state.dtype) * eps


def rollout(
    step_fn: Callable[[Array], Array],
    state: Array,
    num_steps: int,
) -> Array:
    """Autoregressive rollout: returns (num_steps, *state.shape) trajectory.
    ``step_fn`` must be jit-compatible; the loop is a ``lax.scan``."""

    def body(carry, _):
        nxt = step_fn(carry)
        return nxt, nxt

    _, traj = jax.lax.scan(body, state, None, length=num_steps)
    return traj


def ensemble_skill(
    generated: Array,
    reference: Array,
    ensemble_axis: int = 0,
) -> dict:
    """Skill scores of a generated ensemble against a reference field.

    ``generated``: ensemble on ``ensemble_axis``; ``reference``: same shape
    without that axis. Returns CRPS (fair), RMSE of the ensemble mean, mean
    spread (std across members), and the spread/error ratio (≈1 for a
    well-calibrated ensemble).
    """
    gen = jnp.moveaxis(generated, ensemble_axis, 0)
    mean = jnp.mean(gen, axis=0)
    rmse_mean = losses.rmse(mean, reference)
    spread = jnp.sqrt(jnp.mean(jnp.var(gen, axis=0, ddof=1))) if gen.shape[0] > 1 else jnp.zeros(())
    crps = losses.crps_ensemble(gen, reference, ensemble_axis=0, fair=True)
    m = gen.shape[0]
    spread_error = spread * jnp.sqrt((m + 1) / m) / (rmse_mean + 1e-12)
    return {
        "crps": float(crps),
        "rmse_ensemble_mean": float(rmse_mean),
        "spread": float(spread),
        "spread_error_ratio": float(spread_error),
    }


def generate_ensemble(
    model,
    params,
    graph,
    base_state: Array,
    key,
    num_members: int,
    num_steps: int,
    sigma: float = 0.1,
    smoothing_steps: int = 2,
) -> Array:
    """Full pipeline: perturb → rollout each member → (K, T, nodes, ch)."""
    members = sample_perturbed_members(
        key, base_state, num_members, sigma, graph, smoothing_steps
    )

    def step(x):
        return model.apply(params, graph, x)

    # Members ride the batch-native aggregation on the leading axis (one
    # scan, one kernel dispatch per step for ALL members).
    traj = rollout(step, members, num_steps)  # (T, K, nodes, channels)
    return jnp.moveaxis(traj, 0, 1)


def inflate_ensemble(
    generated: Array,
    factor,
    ensemble_axis: int = 0,
) -> Array:
    """Multiplicative ensemble inflation: scale each member's deviation from
    the ensemble mean by ``factor``.

    The standard post-hoc fix for under-dispersive ensembles (spread/error
    ratio < 1): inflation leaves the ensemble mean — and hence its RMSE —
    unchanged while scaling the spread linearly, so ``factor ≈ 1/ratio``
    restores calibration. No reference analog (the reference never measures
    spread); see :func:`calibrate_inflation`.
    """
    mean = jnp.mean(generated, axis=ensemble_axis, keepdims=True)
    return mean + factor * (generated - mean)


def calibrate_inflation(
    generated: Array,
    reference: Array,
    ensemble_axis: int = 0,
    target_ratio: float = 1.0,
    max_factor: float = 10.0,
) -> float:
    """Closed-form inflation factor from one validation ensemble.

    Spread scales linearly with the inflation factor while the ensemble-mean
    RMSE is invariant, so the factor that moves the spread/error ratio to
    ``target_ratio`` is simply ``target_ratio / current_ratio`` (clamped).
    """
    skill = ensemble_skill(generated, reference, ensemble_axis)
    ratio = skill["spread_error_ratio"]
    if not (ratio > 0):
        return 1.0
    return float(min(max(target_ratio / ratio, 1.0 / max_factor), max_factor))


def calibrate_sigma(
    model,
    params,
    graph,
    fields_val,
    key,
    sigmas=(0.01, 0.02, 0.05, 0.1, 0.2),
    num_members: int = 8,
    horizon: int = 4,
    smoothing_steps: int = 2,
) -> dict:
    """Pick the perturbation amplitude by validation CRPS.

    For each candidate sigma, generate an ensemble from every validation
    member's initial state and score it against that member's own trajectory;
    returns the best sigma and the per-sigma score table (CRPS + spread/error
    ratio, which should approach 1 for a calibrated ensemble).
    """
    import numpy as np

    fields_val = jnp.asarray(fields_val)  # (time, member, nodes, channels)
    t, m = fields_val.shape[:2]
    horizon = min(horizon, t - 1)
    table = []
    for sigma in sigmas:
        crps_vals, ratio_vals = [], []
        for mi in range(m):
            k = jax.random.fold_in(key, int(sigma * 1e6) + mi)
            gen = generate_ensemble(
                model, params, graph, fields_val[0, mi], k,
                num_members=num_members, num_steps=horizon, sigma=float(sigma),
                smoothing_steps=smoothing_steps,
            )
            skill = ensemble_skill(gen, fields_val[1 : 1 + horizon, mi])
            crps_vals.append(skill["crps"])
            ratio_vals.append(skill["spread_error_ratio"])
        table.append({
            "sigma": float(sigma),
            "crps": float(np.mean(crps_vals)),
            "spread_error_ratio": float(np.mean(ratio_vals)),
        })
    best = min(table, key=lambda row: row["crps"])
    return {"best_sigma": best["sigma"], "table": table}
