#!/bin/bash
# One-host GPU training launcher (the reference's tools/job.sh was SLURM,
# 1 node x 4 GPUs). One process drives every card of the host: the
# (data, graph) mesh spans them through mesh.data_axis / mesh.graph_axis,
# e.g.  tools/job.sh config.json mesh.graph_axis=4
# The compile cache goes where JAX_COMPILATION_CACHE_DIR says, else to
# <checkout>/.jax_cache (gwen.compile_cache).
set -euo pipefail
CONFIG=${1:-config.json}
python -m gwen train-mesh --config "$CONFIG" "${@:2}"
