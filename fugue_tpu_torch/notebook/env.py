"""The notebook: the ``%%fsql`` cell magic and the HTML display chain,
copied from ``fugue_tpu/notebook/env.py``. Gated on IPython: without it,
or outside an IPython shell, ``setup()`` registers nothing and returns
False.

``%%fsql [engine]`` compiles the cell's FugueSQL, runs it and puts each
yielded frame into the notebook's namespace. With no engine named the
cell runs on the port's default: a ``TorchExecutionEngine`` on
``cuda:0``, not the host; name ``native`` (or ``sqlite``) for a host
engine. Inside IPython, a frame's ``show()`` and its rich repr render an
HTML table with the schema under it.
"""

import html as _html
from typing import Any, List, Optional


def _setup_magic() -> bool:
    try:
        from IPython import get_ipython
        from IPython.core.magic import Magics, cell_magic, magics_class
    except ImportError:
        return False
    ip = get_ipython()
    if ip is None:
        return False

    from ..sql.fsql import FugueSQLCompiler, FugueSQLWorkflow, fill_sql_template

    @magics_class
    class _FugueSQLMagics(Magics):
        @cell_magic("fsql")
        def fsql(self, line: str, cell: str) -> None:
            engine = line.strip() or None
            ns = self.shell.user_ns
            dag = FugueSQLWorkflow()
            code = fill_sql_template(cell, dict(ns))
            compiler = FugueSQLCompiler(dag, {}, dict(ns), dict(ns))
            compiler.compile(code)
            result = dag.run(engine)
            for name, yielded in result.yields.items():
                ns[name] = yielded

    ip.register_magics(_FugueSQLMagics)
    return True


def _setup_display() -> bool:
    """Put the Jupyter HTML renderer of frames on the display chain."""
    try:
        from IPython import get_ipython
        from IPython.display import HTML, display
    except ImportError:
        return False
    if get_ipython() is None:
        return False

    from ..dataframe import DataFrame
    from ..dataframe.dataframe import DataFrameDisplay
    from ..dataset.dataset import register_dataset_display

    class JupyterDataFrameDisplay(DataFrameDisplay):
        def show(self, n: int = 10, with_count: bool = False, title: Optional[str] = None) -> None:
            components: List[Any] = []
            if title is not None:
                components.append(HTML(f"<h3>{_html.escape(title)}</h3>"))
            components.append(HTML(self._df_html(n)))
            if with_count:
                components.append(HTML(f"<strong>total count: {self.df.count()}</strong>"))
            display(*components)

        def repr_html(self) -> str:
            return self._df_html(10)

        def _df_html(self, n: int) -> str:
            pdf = self.df.head(n).as_pandas()
            body = pdf._repr_html_()
            schema = type(self.df).__name__ + ": " + str(self.df.schema)
            return body + '\n<font size="-1">' + _html.escape(schema) + "</font>"

    @register_dataset_display(
        lambda ds: get_ipython() is not None and isinstance(ds, DataFrame), priority=3.0
    )
    def _jupyter_display(ds: Any) -> DataFrameDisplay:
        return JupyterDataFrameDisplay(ds)

    return True


_HIGHLIGHT_JS = r"""
require(["codemirror/lib/codemirror"], function (CodeMirror) {
  CodeMirror.defineMode("fsql", function (config) {
    return CodeMirror.getMode(config, "text/x-sql");
  });
  CodeMirror.modeInfo.push({name: "Fugue SQL", mime: "text/x-fsql", mode: "fsql"});
  var magic = /^%%fsql/;
  function hl(cell) {
    if (cell.get_text !== undefined && magic.test(cell.get_text())) {
      cell.code_mirror.setOption("mode", "fsql");
    }
  }
  if (window.Jupyter !== undefined) {
    Jupyter.notebook.get_cells().forEach(hl);
    Jupyter.notebook.events.on("create.Cell", function (_, d) { hl(d.cell); });
  }
});
"""


def _load_ipython_extension(ip: Any) -> None:
    """The ``%load_ext fugue_tpu_torch.notebook`` hook."""
    _setup_magic()
    _setup_display()


class NotebookSetup:
    """``setup()`` in a notebook turns on ``%%fsql`` and the HTML display."""

    def setup(self) -> bool:
        ok = _setup_magic()
        _setup_display()
        return ok

    @property
    def highlight_js(self) -> str:
        """The codemirror snippet that highlights ``%%fsql`` cells."""
        return _HIGHLIGHT_JS


def setup(run_js: bool = False, **kwargs: Any) -> bool:
    res = NotebookSetup().setup()
    if res and run_js:
        try:
            from IPython.display import Javascript, display

            display(Javascript(_HIGHLIGHT_JS))
        except ImportError:  # pragma: no cover
            pass
    return res
