from gwen.train.checkpoint import Checkpointer
from gwen.train.mesh import (
    data_sharding,
    initialize_distributed,
    is_main_process,
    make_mesh,
    node_sharding,
    replicated,
)
from gwen.train.remat import (
    remat_policy_for_budget,
    select_save_agg_steps,
)
from gwen.train.tasks import cnn_loss_fn, gnn_loss_fn, mesh_loss_fn
from gwen.train.trainer import Trainer, TrainState

__all__ = [
    "Checkpointer",
    "Trainer",
    "TrainState",
    "cnn_loss_fn",
    "gnn_loss_fn",
    "mesh_loss_fn",
    "data_sharding",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "node_sharding",
    "remat_policy_for_budget",
    "replicated",
    "select_save_agg_steps",
]
