"""Segment lowering: one engine step per device-resident plan segment,
copied from ``fugue_tpu/plan/lowering.py``.

After prune/pushdown/fuse this pass identifies **maximal device-resident
segments** — a fused (or still unfused) row-local chain flowing into a
dense aggregate, a take, a distinct, or a broadcast-join probe — and
collapses each into ONE :class:`LoweredSegment` task.

Execution is engine-mediated via ``engine.lowered_segment``:

- the default (every engine) interprets the segment per-verb —
  ``fused_apply`` then the terminal verb with the engine's own methods —
  which is exactly what the unlowered task pair would have run. This is
  also the **refusal path**: a segment the torch engine's gates refuse
  runs this way, counted in ``plan_stats.segments_fallback``;
- the torch engine runs eligible segments over the raw columns
  (``TorchExecutionEngine.lowered_segment``): the chain's Kleene-AND
  predicate and projections evaluate on the device and feed straight into
  the dense aggregate, whose float32 SUM is the hand kernel ``bin_sum``.
  Streaming inputs fold chunk by chunk into device accumulators: a chunk
  goes to the device once and never returns to the host between verbs.

Everything is gated by ``fugue.tpu.plan.lower_segments`` (default ON). A
lowered segment runs under ONE ``plan.segment`` range, in place of
the per-verb spans.
"""

from typing import Any, Dict, List, Optional, Tuple

from .._utils.hash import to_uuid
from ..exceptions import FugueWorkflowError
from ..extensions.processor.processor import Processor
from .fused import describe_step
from .ir import (
    K_AGGREGATE,
    K_DISTINCT,
    K_FUSED,
    K_JOIN,
    K_SEGMENT,
    K_TAKE,
    LNode,
    consumers_map,
)

__all__ = [
    "LoweredSegment",
    "apply_terminal_engine",
    "describe_terminal",
    "lower_segments",
    "segment_fingerprint",
]


class LoweredSegment(Processor):
    """Execute a device-resident plan segment (row-local chain + terminal
    verb) as one engine step."""

    def process(self, dfs: Any) -> Any:
        from .._utils.assertion import assert_or_throw

        steps = self.params.get_or_throw("steps", list)
        terminal = tuple(self.params.get_or_throw("terminal", object))
        expected = 2 if terminal[0] == "join" else 1
        assert_or_throw(
            len(dfs) == expected,
            FugueWorkflowError(
                f"lowered {terminal[0]} segment takes {expected} input(s)"
            ),
        )
        return self.execution_engine.lowered_segment(
            [dfs[i] for i in range(len(dfs))],
            steps,
            terminal,
            self.partition_spec,
            fingerprint=self.params.get("fingerprint", ""),
        )


def segment_fingerprint(steps: List[Tuple], terminal: Tuple) -> str:
    """Stable short id of a segment's shape — labels its
    ``plan.segment`` range and the explain() rendering."""
    return to_uuid(list(steps), list(terminal))[:8]


def describe_terminal(terminal: Tuple) -> str:
    kind = terminal[0]
    if kind == "aggregate":
        return "aggregate[" + ",".join(
            c.infer_alias().output_name for c in terminal[1]
        ) + "]"
    if kind == "take":
        return f"take[{terminal[1]}]"
    if kind == "join":
        return f"join[{terminal[1]}:{','.join(terminal[2])}]"
    return kind


def apply_terminal_engine(
    engine: Any,
    dfs: List[Any],
    steps: List[Tuple],
    terminal: Tuple,
    partition_spec: Any,
) -> Any:
    """Per-verb interpretation of a segment: the chain via
    ``engine.fused_apply`` then the terminal with the engine's own verb —
    exactly what the unlowered task pair executes (the default engine
    implementation AND the torch engine's per-segment refusal path)."""
    kind = terminal[0]
    probe = terminal[3] if kind == "join" else 0
    df = engine.fused_apply(dfs[probe], list(steps)) if steps else dfs[probe]
    if kind == "aggregate":
        return engine.aggregate(df, partition_spec, list(terminal[1]))
    if kind == "take":
        return engine.take(
            df,
            n=terminal[1],
            presort=terminal[2],
            na_position=terminal[3],
            partition_spec=partition_spec,
        )
    if kind == "distinct":
        return engine.distinct(df)
    if kind == "join":
        other = dfs[1 - probe]
        d1, d2 = (df, other) if probe == 0 else (other, df)
        return engine.join(d1, d2, how=terminal[1], on=list(terminal[2]))
    raise FugueWorkflowError(f"unknown segment terminal {kind}")


# ---------------------------------------------------------------------------
# the pass: chain + terminal -> K_SEGMENT
# ---------------------------------------------------------------------------


def _chain_steps(n: LNode) -> List[Tuple]:
    from .passes import _node_steps

    if n.kind == K_FUSED:
        return list(n.steps or [])
    return _node_steps(n)


def _chain_verbs(n: LNode) -> int:
    # how many ORIGINAL verbs this chain node stands for (a fused node
    # already absorbed a whole chain)
    return max(len(n.steps or []), 1) if n.kind == K_FUSED else 1


def _chainable(n: LNode) -> bool:
    from .ir import task_pinned
    from .passes import _fusable

    if n.pinned or len(n.inputs) != 1:
        return False
    if n.kind == K_FUSED:
        # a fused chain whose tail carried yield/broadcast keeps those
        # handlers on ITS task — absorbing it would lose them
        return n.tail_origin is None or not task_pinned(n.tail_origin)
    return _fusable(n)


def _collect_chain(
    tail: LNode, consumer: LNode, cons: Dict[int, List[LNode]]
) -> List[LNode]:
    """Walk producer-ward from ``tail`` (the terminal's input) collecting
    the single-consumer row-local chain, returned head→tail. Empty when
    ``tail`` is not chainable into ``consumer``."""
    if not _chainable(tail) or cons[id(tail)] != [consumer]:
        return []
    chain = [tail]
    while True:
        p = chain[0].inputs[0]
        if not _chainable(p) or cons[id(p)] != [chain[0]]:
            break
        chain.insert(0, p)
    return chain


def _terminal_spec(term: LNode) -> Optional[Tuple]:
    t = term.task
    assert t is not None
    if term.kind == K_AGGREGATE:
        return ("aggregate", tuple(t.params.get("columns", [])))
    if term.kind == K_TAKE:
        return (
            "take",
            t.params.get_or_none("n", int),
            t.params.get("presort", ""),
            t.params.get("na_position", "last"),
        )
    if term.kind == K_DISTINCT:
        return ("distinct",)
    return None  # join spec is built by the caller (needs the probe side)


def lower_segments(nodes: List[LNode], report: Any) -> None:
    """Collapse each (row-local chain → terminal verb) pair into one
    K_SEGMENT node. The terminal may carry yield/broadcast (transferred
    onto the segment task, like fusion's tail rules) but not a
    checkpoint; chain nodes must be fully unpinned — their intermediate
    results are absorbed into the segment."""
    for term in list(nodes):
        if term.kind not in (K_AGGREGATE, K_TAKE, K_DISTINCT, K_JOIN):
            continue
        if term.task is None or not term.task.checkpoint.is_null:
            continue
        cons = consumers_map(nodes)
        chain: List[LNode] = []
        side = 0
        for i, inp in enumerate(term.inputs):
            chain = _collect_chain(inp, term, cons)
            if chain:
                side = i
                break
        if not chain:
            continue
        if term.kind == K_JOIN:
            if len(term.inputs) != 2 or term.inputs[0] is term.inputs[1]:
                continue
            terminal: Optional[Tuple] = (
                "join",
                term.task.params.get_or_throw("how", str),
                tuple(term.task.params.get("on", [])),
                side,
            )
        else:
            if len(term.inputs) != 1:
                continue
            terminal = _terminal_spec(term)
        if terminal is None:
            continue
        steps: List[Tuple] = []
        for c in chain:
            steps.extend(_chain_steps(c))
        fp = segment_fingerprint(steps, terminal)
        seg = LNode(None, K_SEGMENT)
        seg.steps = steps
        seg.terminal = terminal
        seg.tail_origin = term.task
        # the segment's output IS the terminal's output; chain results are
        # absorbed (their handles raise the descriptive optimized-away
        # error, like fused interiors)
        seg.result_of = list(term.result_of)
        new_inputs = list(term.inputs)
        new_inputs[side] = chain[0].inputs[0]
        seg.inputs = new_inputs
        desc = (
            f"lowered segment {fp}: "
            + " | ".join(describe_step(s) for s in steps)
            + " -> "
            + describe_terminal(terminal)
        )
        seg.annotations.append(desc)
        if hasattr(report, "segments"):
            report.segments.append(desc)
        for c in cons[id(term)]:
            c.inputs = [seg if i is term else i for i in c.inputs]
        nodes[nodes.index(term)] = seg
        for c in chain:
            nodes.remove(c)
        report.segments_lowered += 1
        report.verbs_absorbed += sum(_chain_verbs(c) for c in chain) + 1
