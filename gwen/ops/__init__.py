from gwen.ops.aggregate import (
    aggregate,
    aggregate_block_ell_reference,
    aggregate_block_tiles_reference,
    aggregate_dense,
    aggregate_diag_window_reference,
    aggregate_segment,
)
from gwen.ops.attention import windowed_attention

__all__ = [
    "aggregate",
    "aggregate_block_ell_reference",
    "aggregate_block_tiles_reference",
    "aggregate_dense",
    "aggregate_diag_window_reference",
    "aggregate_segment",
    "windowed_attention",
]
