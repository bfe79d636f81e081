from gwen.parallel.apply import make_partitioned_apply
from gwen.parallel.halo import HaloGraph, aggregate_halo, halo_exchange
from gwen.parallel.partition import PartitionedGraph, partition_graph

__all__ = [
    "HaloGraph",
    "PartitionedGraph",
    "aggregate_halo",
    "halo_exchange",
    "make_partitioned_apply",
    "partition_graph",
]
