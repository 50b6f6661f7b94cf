"""The port's plugin packages (``_utils/registry.py``, ``plugins.py``,
``contrib/viz.py``, ``dev.py``, ``test/plugins.py``) against the JAX
package's.

The cases are those of ``tests/core/test_entry_point_plugins.py`` and the
plugin and test-suite cases of ``tests/core/test_aux.py``
(``TestHarnessPlugins``), each through both packages: a synthetic
third-party distribution registers an engine through each package's own
entry-point group (``fugue_tpu.plugins``, ``fugue_tpu_torch.plugins``).
Then the parse of ``"viz:bar"``, every name of ``dev.py`` and
``plugins.py`` resolved to a port object, and the one dispatcher behind
the converters' ``parse_*`` hooks.
"""

import inspect
import sys
import textwrap
import types

import pandas as pd
import pytest

import fugue_tpu.dev as jdev
import fugue_tpu.plugins as jplugins
from fugue_tpu._utils import registry as jregistry
from fugue_tpu.exceptions import FuguePluginsRegistrationError as JRegError
from fugue_tpu.execution import factory as jfactory

import fugue_tpu_torch.dev as tdev
import fugue_tpu_torch.plugins as tplugins
from fugue_tpu_torch._utils import registry as tregistry
from fugue_tpu_torch.exceptions import FuguePluginsRegistrationError
from fugue_tpu_torch.execution import factory as tfactory
from fugue_tpu_torch.extensions._shared import ParseHook

_MODULE = textwrap.dedent(
    '''
    """Synthetic third-party backend package (test fixture)."""
    from {pkg}.execution.factory import register_execution_engine
    from {pkg}.execution.native_execution_engine import NativeExecutionEngine


    class ExtEngine(NativeExecutionEngine):
        marker = "loaded-via-entry-point"


    register_execution_engine("extengine", lambda conf, **k: ExtEngine(conf))
    '''
)

REF = types.SimpleNamespace(name="fugue_tpu", registry=jregistry, factory=jfactory, Error=JRegError)
PORT = types.SimpleNamespace(name="fugue_tpu_torch", registry=tregistry, factory=tfactory,
                             Error=FuguePluginsRegistrationError)


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def synthetic_dist(request, tmp_path):
    pkg = request.param
    mod = f"my_{pkg.name}_ext"
    site = tmp_path / "site"
    dist = site / f"{mod}-0.1.dist-info"
    dist.mkdir(parents=True)
    (site / f"{mod}.py").write_text(_MODULE.format(pkg=pkg.name))
    (dist / "METADATA").write_text(f"Metadata-Version: 2.1\nName: {mod}\nVersion: 0.1\n")
    (dist / "entry_points.txt").write_text(f"[{pkg.name}.plugins]\nextengine = {mod}\n")
    sys.path.insert(0, str(site))
    prior = pkg.registry._EP_STATE["loaded"]
    pkg.registry._EP_STATE["loaded"] = False
    try:
        yield pkg, mod
    finally:
        sys.path.remove(str(site))
        pkg.registry._EP_STATE["loaded"] = prior
        sys.modules.pop(mod, None)
        pkg.factory._EXECUTION_ENGINE_REGISTRY.pop("extengine", None)


def test_engine_resolves_without_import(synthetic_dist):
    pkg, mod = synthetic_dist
    assert mod not in sys.modules
    e = pkg.factory.make_execution_engine("extengine")
    assert getattr(e, "marker", "") == "loaded-via-entry-point"
    assert mod in sys.modules  # loaded by discovery, not by the test
    e.stop_engine()


def test_load_is_idempotent(synthetic_dist):
    pkg, _ = synthetic_dist
    loaded = pkg.registry.load_entry_point_plugins()
    assert "extengine" in loaded
    assert pkg.registry.load_entry_point_plugins() == []  # the second call does nothing


def test_unknown_engine_still_raises(synthetic_dist):
    pkg, _ = synthetic_dist
    with pytest.raises(pkg.Error):
        pkg.factory.make_execution_engine("definitely-not-registered")


def test_the_port_reads_its_own_entry_point_group():
    assert tregistry.ENTRY_POINT_GROUP == "fugue_tpu_torch.plugins"
    assert jregistry.ENTRY_POINT_GROUP == "fugue_tpu.plugins"


@pytest.mark.parametrize("test_pkg", ["fugue_tpu.test", "fugue_tpu_torch.test"])
def test_suite_binding(test_pkg):
    """``TestHarnessPlugins.test_suite_binding``."""
    mod = __import__(test_pkg, fromlist=["fugue_test_suite"])

    @mod.fugue_test_suite("native")
    class MySuite:
        pass

    engine = MySuite().make_engine()
    assert engine.get_current_parallelism() == 1
    engine.stop()


@pytest.mark.parametrize("test_pkg", ["fugue_tpu.test", "fugue_tpu_torch.test"])
def test_with_backend(test_pkg):
    """``TestHarnessPlugins.test_with_backend``: the wrapped test is
    parametrized over the backends, and each backend's engine context
    yields its engine."""
    mod = __import__(test_pkg, fromlist=["with_backend", "plugins"])
    seen = []

    @mod.with_backend("native", "pandas")
    def check(backend_engine):
        seen.append(type(backend_engine).__name__)

    marks = [m for m in getattr(check, "pytestmark", []) if m.name == "parametrize"]
    assert marks and list(marks[0].args[1]) == ["native", "pandas"]
    for b in ("native", "pandas"):
        with mod.plugins.get_test_backend(b).engine_context() as e:
            seen.append(type(e).__name__)
    assert seen == ["NativeExecutionEngine"] * 2


def test_the_torch_backend_takes_its_device_from_the_session_conf():
    """``torch`` takes the place of the reference's ``jax`` backend: its
    engine is on ``cuda:0`` unless ``session_conf`` names a device."""
    from fugue_tpu_torch.test import fugue_test_backend, get_test_backend
    from fugue_tpu_torch.test.plugins import FugueTestBackend

    assert get_test_backend("torch").session_conf == {}

    @fugue_test_backend
    class CpuTorch(FugueTestBackend):
        name = "torch_cpu_test"
        session_conf = {"device": "cpu", "fugue.tpu.stream.chunk_rows": 512}

        @classmethod
        def session_context(cls):
            return get_test_backend("torch").session_context()

    with get_test_backend("torch_cpu_test").engine_context() as e:
        assert type(e).__name__ == "TorchExecutionEngine" and str(e.device) == "cpu"
        assert e.conf.get("fugue.tpu.stream.chunk_rows", 0) == 512
    with pytest.raises(KeyError):
        get_test_backend("jax")


def test_pytest_configure_registers_one_marker_a_backend():
    from fugue_tpu_torch.test import plugins as tp

    lines = []
    config = types.SimpleNamespace(addinivalue_line=lambda k, v: lines.append((k, v)))
    prior = tp._PYTEST_CONFIG[0]
    try:
        tp.pytest_configure(config)
    finally:
        tp._PYTEST_CONFIG[0] = prior
    names = {v.split(":")[0] for k, v in lines if k == "markers"}
    assert {"native", "pandas", "torch"} <= names


def test_viz_parses_as_an_outputter():
    """``"viz:bar"`` parses as an outputter in both packages; it plots with
    matplotlib and raises ``NotImplementedError`` without it."""
    import fugue_tpu.contrib  # noqa: F401
    import fugue_tpu_torch.contrib  # noqa: F401
    from fugue_tpu.dataframe import ArrayDataFrame as JArray
    from fugue_tpu.dataframe import DataFrames as JDataFrames
    from fugue_tpu.extensions.outputter.convert import _to_outputter as jto
    from fugue_tpu_torch.dataframe import ArrayDataFrame, DataFrames
    from fugue_tpu_torch.extensions.outputter.convert import _to_outputter as tto

    try:
        import matplotlib

        matplotlib.use("Agg")
        has_mpl = True
    except ImportError:
        has_mpl = False
    results = []
    for to, Array, Frames in ((jto, JArray, JDataFrames), (tto, ArrayDataFrame, DataFrames)):
        o = to("viz:bar")
        assert type(o).__name__ == "_VizOutputter" and o._kind == "bar"
        dfs = Frames(Array([[1, 2.0]], "a:long,b:double"))
        if has_mpl:
            o.process(dfs)
            results.append("plotted")
        else:
            with pytest.raises(NotImplementedError, match="matplotlib"):
                o.process(dfs)
            results.append("refused")
        with pytest.raises(Exception):
            to("viz:nonsense-kind")
    assert results[0] == results[1]
    assert type(tto("viz:bar")).__module__ == "fugue_tpu_torch.contrib.viz"


def _public(mod):
    return {n: v for n, v in vars(mod).items() if not n.startswith("_") and not inspect.ismodule(v)}


def _is_port_object(v):
    return getattr(v, "__module__", "").startswith("fugue_tpu_torch")


@pytest.mark.parametrize("ref,port", [(jdev, tdev), (jplugins, tplugins)], ids=["dev", "plugins"])
def test_every_name_resolves_to_a_port_object(ref, port):
    ref_names, port_names = _public(ref), _public(port)
    assert set(ref_names) <= set(port_names), sorted(set(ref_names) - set(port_names))
    for name in ref_names:
        obj = port_names[name]
        assert _is_port_object(obj), (name, obj)
        assert not getattr(obj, "__module__", "").startswith("fugue_tpu.")


def test_one_dispatcher_behind_the_parse_hooks():
    """Every ``parse_*`` hook of the port is the registry's dispatcher, and
    candidates run as the reference's do: highest priority first, the
    later registration first among equals, the default last."""
    from fugue_tpu_torch.extensions.creator.convert import parse_creator
    from fugue_tpu_torch.extensions.outputter.convert import parse_outputter
    from fugue_tpu_torch.extensions.processor.convert import parse_processor
    from fugue_tpu_torch.extensions.transformer.convert import parse_output_transformer, parse_transformer

    for hook in (parse_creator, parse_outputter, parse_processor, parse_transformer, parse_output_transformer):
        assert isinstance(hook, ParseHook) and isinstance(hook, tregistry.ConditionalDispatcher)
    assert ParseHook.__mro__[1] is tregistry.ConditionalDispatcher
    assert tplugins.parse_outputter is parse_outputter
    assert isinstance(tplugins.parse_execution_engine, tregistry.ConditionalDispatcher)

    order = {}
    for name, reg in (("ref", jregistry), ("port", tregistry)):
        hook = ParseHook() if name == "port" else reg.fugue_plugin(lambda obj: ("default", obj))
        calls = []
        hook.candidate(lambda o: o == "x", priority=1.0)(lambda o: calls.append("p1-first") or "p1-first")
        hook.candidate(lambda o: o == "x", priority=1.0)(lambda o: calls.append("p1-later") or "p1-later")
        hook.candidate(lambda o: o == "x", priority=2.0)(lambda o: calls.append("p2") or "p2")
        first = hook("x")
        hook.candidate(lambda o: o == "x", priority=3.0)(lambda o: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            hook("x")
        order[name] = (first, hook.has_match("y"))
        assert hook("y") in ("y", ("default", "y"))
    assert order["port"] == order["ref"] == ("p2", False)


def test_registered_engines_and_sql_engines_resolve():
    """``register_execution_engine`` by name and by type,
    ``register_default_execution_engine`` and ``make_sql_engine`` answer
    as the reference's do."""
    from fugue_tpu_torch.execution.native_execution_engine import NativeExecutionEngine

    class Marker:
        pass

    tfactory.register_execution_engine("named_ext", lambda conf, **k: NativeExecutionEngine(conf))
    tfactory.register_execution_engine(Marker, lambda obj, conf, **k: NativeExecutionEngine(conf))
    try:
        assert type(tfactory.make_execution_engine("named_ext")).__name__ == "NativeExecutionEngine"
        assert type(tfactory.make_execution_engine(Marker())).__name__ == "NativeExecutionEngine"
        with pytest.raises(FuguePluginsRegistrationError):
            tfactory.register_execution_engine("named_ext", lambda conf: None, on_dup="throw")
        e = tfactory.make_execution_engine("torch", device="cpu")
        assert tfactory.make_sql_engine(None, e) is e.sql_engine
        with pytest.raises(FuguePluginsRegistrationError):
            tfactory.make_sql_engine("no-such-sql", e)
        assert tfactory.is_pandas_or([pd.DataFrame()], int) and not tfactory.is_pandas_or([1.5], int)
        with pytest.raises(ValueError, match="unknown engine"):
            tfactory.make_execution_engine("jax", device="cpu")
    finally:
        tfactory._EXECUTION_ENGINE_REGISTRY.pop("named_ext", None)
        tfactory._EXECUTION_ENGINE_TYPE_REGISTRY.pop(Marker, None)


@pytest.mark.parametrize("pkg", ["fugue_tpu", "fugue_tpu_torch"])
def test_workflow_dataframes_container(pkg):
    """``tests/core/test_api_facade.py::test_workflow_dataframes_container``
    through both packages (the class is one of ``dev.py``'s names)."""
    wf = __import__(f"{pkg}.workflow.workflow", fromlist=["FugueWorkflow", "WorkflowDataFrames"])
    err = __import__(f"{pkg}.exceptions", fromlist=["FugueWorkflowCompileError"]).FugueWorkflowCompileError
    WorkflowDataFrames = wf.WorkflowDataFrames
    dag = wf.FugueWorkflow()
    a = dag.df([[1]], "a:int")
    b = dag.df([[2]], "b:int")
    arr = WorkflowDataFrames(a, b)
    assert not arr.has_key and arr["_0"] is a and arr["_1"] is b and arr[1] is b
    named = WorkflowDataFrames(x=a, y=b)
    assert named.has_key and named.workflow is dag
    merged = WorkflowDataFrames(arr, named)
    assert list(merged) == ["_0", "_1", "x", "y"]
    with pytest.raises(err):
        WorkflowDataFrames(a, wf.FugueWorkflow().df([[3]], "c:int"))
    with pytest.raises(err):
        WorkflowDataFrames(123)
    with pytest.raises(Exception):
        arr["z"] = a  # read-only once built
