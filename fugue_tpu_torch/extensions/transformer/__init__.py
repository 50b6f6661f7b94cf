from .convert import (
    cotransformer,
    output_cotransformer,
    output_transformer,
    parse_output_transformer,
    parse_transformer,
    register_output_transformer,
    register_transformer,
    transformer,
)
from .transformer import CoTransformer, OutputCoTransformer, OutputTransformer, Transformer

__all__ = [
    "CoTransformer",
    "OutputCoTransformer",
    "OutputTransformer",
    "Transformer",
    "cotransformer",
    "output_cotransformer",
    "output_transformer",
    "parse_output_transformer",
    "parse_transformer",
    "register_output_transformer",
    "register_transformer",
    "transformer",
]
