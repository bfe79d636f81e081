"""gwen — a JAX GNN framework for weather ensemble generation.

Built from scratch in JAX/XLA/Pallas with the capabilities of MeteoSwiss/GWEN
(see SURVEY.md): zarr ensemble ingestion, graph construction over ensemble
members and weather meshes, GCN / encode-process-decode model families with
a diagonal-window SpMM aggregation (Pallas/Triton on the GPU), loss library
(masked L1, CRPS, ensemble variance regularization), multi-device training
over a ``jax.sharding.Mesh`` (data parallel over members + edge-partitioned
graph parallelism with halo exchange), checkpointing, an experiment
registry, and GIF visualization.
"""

from gwen.version import __author__, __version__

from gwen.config import GwenConfig, load_config
from gwen.logging_utils import get_logger, setup_logger, suppress_warnings

__all__ = [
    "__author__",
    "__version__",
    "GwenConfig",
    "load_config",
    "get_logger",
    "setup_logger",
    "suppress_warnings",
]
