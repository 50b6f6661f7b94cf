"""``viz:*`` namespaced outputters, copied from ``fugue_tpu/contrib/viz.py``:
a string such as ``"viz:bar"`` parses as an outputter that plots each
frame with pandas ``.plot``. It needs matplotlib; without it, ``process``
raises ``NotImplementedError``, as in the JAX package."""

from ..dataframe import DataFrames
from ..extensions.outputter.convert import parse_outputter
from ..extensions.outputter.outputter import Outputter
from ..plugins import namespace_candidate

_PLOT_KINDS = {
    "line", "bar", "barh", "hist", "box", "kde", "density", "area",
    "pie", "scatter", "hexbin",
}


class _VizOutputter(Outputter):
    def __init__(self, kind: str):
        self._kind = kind

    def process(self, dfs: DataFrames) -> None:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise NotImplementedError("viz:* outputters require matplotlib") from e
        for df in dfs.values():
            df.as_pandas().plot(kind=self._kind, **dict(self.params))


@parse_outputter.candidate(namespace_candidate("viz", lambda x: x in _PLOT_KINDS))
def _parse_viz(obj: str) -> Outputter:
    return _VizOutputter(obj.split(":", 1)[1])
