"""The port's bags (``fugue_tpu_torch/bag``) against the JAX package's:
each case of ``fugue_tpu_test/bag_suite.py`` (``tests/core/test_bag.py``
runs it on ``ArrayBag``) runs on both packages' ``ArrayBag`` over the
same items, and what it observes (counts, peeks, heads, flags, metadata,
raised errors, the text ``show()`` prints) is held equal. Also the
display chain: a bag's ``show`` and ``_repr_html_``, and the dataset
functions of ``fugue_tpu_torch.api`` on a bag."""

import contextlib
import io
from types import SimpleNamespace

import pytest

from fugue_tpu.bag.array_bag import ArrayBag as JArrayBag
from fugue_tpu.exceptions import FugueDatasetEmptyError as JEmpty

from fugue_tpu_torch import ArrayBag, Bag, Dataset, LocalBoundedBag, api
from fugue_tpu_torch.execution import NativeExecutionEngine
from fugue_tpu_torch.exceptions import FugueDatasetEmptyError

J = SimpleNamespace(name="ref", bag=lambda d=None, **kw: JArrayBag(d if d is not None else [], **kw), Empty=JEmpty)
T = SimpleNamespace(name="port", bag=lambda d=None, **kw: ArrayBag(d if d is not None else [], **kw), Empty=FugueDatasetEmptyError)


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _meta(b):
    seen = [b.num_partitions >= 1, b.has_metadata]
    b.reset_metadata({"k": "v"})
    seen.append(b.metadata["k"])
    b.reset_metadata(None)
    return seen + [b.has_metadata]


def _empty(M):
    b = M.bag([])
    with pytest.raises(M.Empty):
        b.peek()
    return b.empty, b.count()


CASES = {
    "init": lambda M: (lambda b: (b.empty, b.count(), b.is_local, b.is_bounded))(M.bag([1, "x", None])),
    "empty": _empty,
    "peek_as_array": lambda M: (M.bag([5, 6]).peek(), M.bag([5, 6]).as_array()),
    "head": lambda M: (lambda h: (h.as_array(), h.is_bounded))(M.bag(list(range(10))).head(3)),
    "head_edges": lambda M: (M.bag([1, 2]).head(0).as_array(), M.bag([1, 2]).head(10).as_array()),
    "special_values": lambda M: repr(M.bag([None, float("nan"), "", 0, False, b"\x00"]).as_array()),
    "mixed_object_types": lambda M: M.bag([dict(a=1), [1, 2], ("t", 1), {3, 4}]).as_array(),
    "as_local_identity": lambda M: (lambda b: (b.as_local() is b, b.as_local().is_local,
                                               b.as_local().as_array()))(M.bag([1, 2, 3])),
    "num_partitions_and_metadata": lambda M: _meta(M.bag([1])),
    "show": lambda M: _printed(lambda: (M.bag([1, "x", None]).show(), M.bag([]).show(),
                                        M.bag(list(range(20))).show(n=3, with_count=True, title="t"))),
    "large_bag": lambda M: (M.bag(list(range(10_000))).count(), M.bag(list(range(10_000))).head(5).as_array()),
    "copy": lambda M: (lambda src: (M.bag(src, copy=False).native is src, M.bag(src).native is src,
                                    M.bag(M.bag(src)).as_array(), M.bag(iter(range(3))).as_array()))([1, 2]),
    "bad_input": lambda M: M.bag(5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bag_suite_case(case):
    out = {}
    for M in (J, T):
        try:
            out[M.name] = CASES[case](M)
        except Exception as e:
            out[M.name] = ("raised", type(e).__name__)
    assert out["port"] == out["ref"], out
    assert out["port"][0] != "raised" or case == "bad_input"


def test_bag_classes_and_display():
    b = ArrayBag([1, "x"])
    assert isinstance(b, LocalBoundedBag) and isinstance(b, Bag) and isinstance(b, Dataset)
    assert b._repr_html_() == "<pre>ArrayBag</pre>" == JArrayBag([1, "x"])._repr_html_()
    assert api.count(b) == 2 and not api.is_empty(b) and api.is_local(b) and api.is_bounded(b)
    assert api.get_num_partitions(b) == 1
    assert _printed(lambda: api.show(b)) == _printed(lambda: b.show())


def test_no_map_supports_bags():
    """As in the JAX package, no map of the port supports bags yet."""
    with pytest.raises(NotImplementedError, match="bags"):
        NativeExecutionEngine().map_engine.map_bag(ArrayBag([1]), lambda *a: a, None)
