"""The annotated parameter of a device-compiled transformer, the port of
``fugue_tpu/jax_annotations.py``.

A function annotated ``Dict[str, torch.Tensor] -> Dict[str, torch.Tensor]``
(code ``t``, ``dict[str, torch.Tensor]`` alike) is the port's device
transformer. With that one parameter, ``api.transform`` runs it on the
engine's device over the frame's columns, with no host round trip
(``TorchMapEngine``, which reads the raw function through
:func:`sniff_torch_func`). With more parameters it runs on the host
engine, once a partition, over CPU tensors of the partition's columns, as
the JAX package runs such a ``Dict[str, jax.Array]`` function.

Contract: the input dict includes a reserved ``"__valid__"`` bool tensor
marking real rows. A frame carried over from the JAX package keeps its
padding rows, and a keyed map sorts invalid rows to the end, so per-frame
and per-group reductions MUST mask with it; elementwise code can ignore
it. A keyed transformer also gets the reserved grouping keys of
``fugue_tpu_torch.torch.group_ops`` and reduces through its helpers.

A keyless transformer sees the whole frame as one block on the one device,
where the JAX package traces it once per mesh shard: the two agree only
where the output does not depend on the shard layout (elementwise maps,
or reductions through the keyed helpers).
"""

import typing
from typing import Any, Callable, Dict, Optional

import pyarrow as pa
import torch

from .dataframe import ArrowDataFrame, DataFrame
from .dataframe.function_wrapper import LocalDataFrameParam, fugue_annotated_param
from .schema import Schema

VALID = "__valid__"


def _is_torch_dict(a: Any) -> bool:
    return typing.get_origin(a) is dict and typing.get_args(a) == (str, torch.Tensor)


@fugue_annotated_param(code="t", matcher=_is_torch_dict)
class TorchDictParam(LocalDataFrameParam):
    """On the host engine: the partition's columns as CPU tensors (strings
    as dictionary codes, NULLs filled, as the device holds them), and the
    output dict back to a frame of the output schema."""

    @property
    def format_hint(self) -> Optional[str]:
        return "torch"

    @property
    def need_schema(self) -> Optional[bool]:
        return True

    def to_input_data(self, df: DataFrame) -> Dict[str, torch.Tensor]:
        from .torch.dataframe import encode_arrow_for_device

        cols, _, _ = encode_arrow_for_device(df.as_arrow())
        res = {k: torch.from_numpy(v.copy()) for k, v in cols.items()}
        if len(res) > 0:
            res[VALID] = torch.ones(next(iter(res.values())).shape[0], dtype=torch.bool)
        return res

    def to_output_df(self, output: Any, schema: Optional[Schema]) -> DataFrame:
        if not isinstance(output, dict) or schema is None:
            raise TypeError("a Dict[str, torch.Tensor] transformer must return a dict")
        arrays = [
            pa.array(output[f.name].detach().cpu().numpy()).cast(f.type, safe=False)
            for f in schema.fields
        ]
        return ArrowDataFrame(pa.Table.from_arrays(arrays, schema=schema.pa_schema))


def sniff_torch_func(map_func: Callable) -> Optional[Callable]:
    """The raw ``Dict[str, torch.Tensor]`` function behind a transformer
    runner's ``run``, when the transformer is an interfaceless function of
    that one parameter (codes ``t`` → ``t``); None for any other
    (``_sniff_jax_func``, ``fugue_tpu/jax/execution_engine.py`` :4328)."""
    runner = getattr(map_func, "__self__", None)
    tf = getattr(runner, "transformer", None)
    wrapper = getattr(tf, "_wrapper", None)
    if wrapper is None or wrapper.input_code != "t" or wrapper.output_code != "t":
        return None
    if getattr(tf, "using_callback", False):
        return None  # a callback runs on the host, once a partition
    return wrapper.func
