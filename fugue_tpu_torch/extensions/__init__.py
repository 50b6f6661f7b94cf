from .context import ExtensionContext
from .creator.convert import creator, parse_creator, register_creator
from .creator.creator import Creator
from .outputter.convert import outputter, parse_outputter, register_outputter
from .outputter.outputter import Outputter
from .processor.convert import parse_processor, processor, register_processor
from .processor.processor import Processor
from .transformer import (
    CoTransformer,
    OutputCoTransformer,
    OutputTransformer,
    Transformer,
    cotransformer,
    output_cotransformer,
    output_transformer,
    parse_output_transformer,
    parse_transformer,
    register_output_transformer,
    register_transformer,
    transformer,
)

__all__ = [
    "CoTransformer",
    "Creator",
    "ExtensionContext",
    "OutputCoTransformer",
    "OutputTransformer",
    "Outputter",
    "Processor",
    "Transformer",
    "cotransformer",
    "creator",
    "output_cotransformer",
    "output_transformer",
    "outputter",
    "parse_creator",
    "parse_output_transformer",
    "parse_outputter",
    "parse_processor",
    "parse_transformer",
    "processor",
    "register_creator",
    "register_output_transformer",
    "register_outputter",
    "register_processor",
    "register_transformer",
    "transformer",
]
