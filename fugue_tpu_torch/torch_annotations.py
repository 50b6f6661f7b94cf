"""The annotation of a device-compiled transformer, the port of
``fugue_tpu/jax_annotations.py`` and of the JAX engine's
``_sniff_jax_func``.

A function annotated ``Dict[str, torch.Tensor] -> Dict[str, torch.Tensor]``
is the port's device transformer: ``api.transform`` runs it on the
engine's device over the frame's columns, with no host round trip. The
port has no function-wrapper registry; it reads the contract from
``typing.get_type_hints``: one parameter, and it and the return are both
``Dict[str, torch.Tensor]`` (``dict[str, torch.Tensor]`` is the same
annotation). Any other function (pandas, arrow or list annotated, or one
with more parameters) is a host transformer, which the port does not run:
it raises ``NotImplementedError``.

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

import inspect
import typing
from typing import Any, Callable

import torch

_HOST_UDFS = "ROADMAP.md A.4b host transformers"


def _is_torch_dict(a: Any) -> bool:
    return typing.get_origin(a) is dict and typing.get_args(a) == (str, torch.Tensor)


def torch_dict_udf(fn: Callable) -> Callable:
    """``fn`` itself when it is annotated ``Dict[str, torch.Tensor] ->
    Dict[str, torch.Tensor]`` with one parameter; otherwise raise
    ``NotImplementedError``: the JAX package runs such a function on its
    host engine, and the port has none."""
    if not callable(fn):
        raise TypeError(f"{fn!r} is not callable")
    try:
        hints = typing.get_type_hints(fn)
        params = list(inspect.signature(fn).parameters.values())
    except (NameError, TypeError, ValueError) as e:
        raise NotImplementedError(
            f"{fn!r} has no readable annotations ({e}); only Dict[str, torch.Tensor] "
            f"transformers run on the port ({_HOST_UDFS})"
        ) from e
    ok = (
        len(params) == 1
        and params[0].kind in (params[0].POSITIONAL_ONLY, params[0].POSITIONAL_OR_KEYWORD)
        and _is_torch_dict(hints.get(params[0].name))
        and _is_torch_dict(hints.get("return"))
    )
    if not ok:
        raise NotImplementedError(
            f"{getattr(fn, '__name__', fn)!r} is not annotated Dict[str, torch.Tensor] -> "
            "Dict[str, torch.Tensor] with one parameter; the JAX package runs such a "
            f"transformer on its host engine, which is not ported ({_HOST_UDFS})"
        )
    return fn
