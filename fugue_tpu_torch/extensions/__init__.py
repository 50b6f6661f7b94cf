from .transformer import (
    OutputTransformer,
    Transformer,
    output_transformer,
    transformer,
)

__all__ = ["OutputTransformer", "Transformer", "output_transformer", "transformer"]
