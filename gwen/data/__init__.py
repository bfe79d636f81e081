from gwen.data.dataset import (
    ConvEnsembleDataset,
    MemberGraphDataset,
    load_data,
    load_split,
    make_datasets,
)
from gwen.data.pipeline import device_pipeline, prefetch, shard_batches

__all__ = [
    "ConvEnsembleDataset",
    "MemberGraphDataset",
    "load_data",
    "load_split",
    "make_datasets",
    "device_pipeline",
    "prefetch",
    "shard_batches",
]
