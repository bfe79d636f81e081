from gwen.nn.attention import graph_attention_apply, graph_attention_init
from gwen.nn.gnn import EncodeProcessDecode, GCNStack
from gwen.nn.layers import gcn_apply, gcn_init

__all__ = [
    "EncodeProcessDecode",
    "GCNStack",
    "gcn_apply",
    "gcn_init",
    "graph_attention_apply",
    "graph_attention_init",
]
