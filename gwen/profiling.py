"""Profiling and performance observability.

The reference has no profiling subsystem (SURVEY §5: closest artifact is a
leftover ``CUDA_LAUNCH_BLOCKING=1``). Here:

* :func:`timeit` — wall-clock timing of jitted fns, ending in a readback.
* :func:`scan_timeit` — per-iteration time of a body chained on device.
* :class:`StepTimer` — rolling per-step stats with derived throughput
  (steps/s, edges/s, items/s).
* :func:`trace` / :func:`start_server` — ``jax.profiler`` integration (view
  with TensorBoard / xprof).
* :func:`device_memory_stats` — per-device memory in use (``None`` where
  the backend keeps no statistics, as on the CPU).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Iterator, Optional

import jax


def timeit(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 1,
    chain: Optional[Callable] = None,
) -> dict:
    """Time ``fn(*args)``; the barrier is a readback of one scalar of
    every output leaf. Pass ``chain`` (``output -> next args tuple``) to
    make every iteration's input depend on the previous output.
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _fetch_scalar(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*(chain(out) if chain is not None else args))
    _fetch_scalar(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters": iters}


def scan_timeit(
    body: Callable,
    carry,
    *invariant,
    iters: int = 100,
    repeats: int = 3,
) -> dict:
    """Per-iteration time of ``body(carry, *invariant) -> carry`` via an
    on-device ``lax.scan`` chain with difference-method readout:

    * the loop runs on the device (one dispatch per measurement),
    * the chain threads ``carry`` through every iteration (nothing is
      hoisted), and
    * the reported time is ``(T(2N) - T(N)) / N``, so every fixed cost
      (dispatch, readback) cancels.

    ``invariant`` args are passed through as jit *arguments* — never close
    over device arrays in ``body`` (big closed-over constants are inlined
    into the program and slow its compile).
    """
    import functools

    @functools.partial(jax.jit, static_argnums=0)
    def many(n, c, *inv):
        return jax.lax.scan(
            lambda cc, _: (body(cc, *inv), None), c, None, length=n
        )[0]

    c = many(iters, carry, *invariant)  # compile + warm (N)
    _fetch_one(c)
    c = many(2 * iters, c, *invariant)  # compile + warm (2N)
    _fetch_one(c)
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        c = many(iters, c, *invariant)
        _fetch_one(c)
        t1 = time.perf_counter()
        c = many(2 * iters, c, *invariant)
        _fetch_one(c)
        t2 = time.perf_counter()
        times.append(((t2 - t1) - (t1 - t0)) / iters)
    times.sort()
    return {"mean_s": times[len(times) // 2], "iters": iters}


@jax.jit
def _probe_first(a):
    return a.ravel()[0].astype("float32")


def _fetch_one(out) -> float:
    """Readback barrier through the first array leaf only (one 4-byte
    transfer)."""
    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "ravel") and getattr(leaf, "size", 0):
            return float(_probe_first(leaf))
    return 0.0


def _fetch_scalar(out) -> float:
    """Force full execution of ``out``'s dependency chain by reading back one
    scalar from each array leaf (pre-compiled probe; 4 bytes per leaf)."""
    total = 0.0
    for leaf in jax.tree_util.tree_leaves(out):
        if hasattr(leaf, "ravel") and getattr(leaf, "size", 0):
            total += float(_probe_first(leaf))
        elif isinstance(leaf, (int, float)):
            total += float(leaf)
    return total


class StepTimer:
    """Rolling window of training-step durations + throughput metrics."""

    def __init__(self, window: int = 50, edges_per_step: int = 0, items_per_step: int = 0):
        self.durations: deque[float] = deque(maxlen=window)
        self.edges_per_step = edges_per_step
        self.items_per_step = items_per_step
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self.durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def mean_step_s(self) -> float:
        return sum(self.durations) / len(self.durations) if self.durations else float("nan")

    def stats(self) -> dict:
        mean = self.mean_step_s
        out = {"step_time_s": mean, "steps_per_s": (1.0 / mean if mean > 0 else 0.0)}
        if self.edges_per_step:
            out["edges_per_s"] = self.edges_per_step / mean
        if self.items_per_step:
            out["items_per_s"] = self.items_per_step / mean
        return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace around a code block."""
    with jax.profiler.trace(log_dir):
        yield


def start_server(port: int = 9999) -> None:
    """Start the profiler server for live capture (jax.profiler UI)."""
    jax.profiler.start_server(port)


def annotate(name: str):
    """Named trace annotation for profiler timelines."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats() -> list[dict]:
    out = []
    for d in jax.local_devices():
        s = d.memory_stats() or {}
        out.append({
            "device": str(d),
            "bytes_in_use": s.get("bytes_in_use"),
            "bytes_limit": s.get("bytes_limit"),
        })
    return out
