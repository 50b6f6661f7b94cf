from .convert import (
    output_transformer,
    parse_output_transformer,
    parse_transformer,
    register_output_transformer,
    register_transformer,
    transformer,
)
from .transformer import OutputTransformer, Transformer

__all__ = [
    "OutputTransformer",
    "Transformer",
    "output_transformer",
    "parse_output_transformer",
    "parse_transformer",
    "register_output_transformer",
    "register_transformer",
    "transformer",
]
