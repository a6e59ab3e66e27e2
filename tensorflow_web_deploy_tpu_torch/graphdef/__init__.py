"""Frozen-graph ingestion (counterpart of the JAX package's ``graphdef/``):
protobuf wire parsing + GraphDef → ``torch.nn.Module`` conversion."""

from .converter import ConvertedModel, InputSpec, convert_graphdef, convert_pb
from .proto import GraphDef, NodeDef, load_pb, parse_graphdef

__all__ = [
    "ConvertedModel",
    "GraphDef",
    "InputSpec",
    "NodeDef",
    "convert_graphdef",
    "convert_pb",
    "load_pb",
    "parse_graphdef",
]
