from .convert import output_transformer, transformer
from .transformer import OutputTransformer, Transformer

__all__ = ["OutputTransformer", "Transformer", "output_transformer", "transformer"]
