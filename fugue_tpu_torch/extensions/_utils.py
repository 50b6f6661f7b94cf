"""Validation rules, copied from ``fugue_tpu/extensions/_utils.py``: a
transformer's rules on the partition spec (``partitionby_has``,
``partitionby_is``, ``presort_has``, ``presort_is``) and on its input
schema (``input_has``, ``input_is``), from keywords or ``# rule:``
comments above its function."""

from typing import Any, Dict

from ..collections.partition import PartitionSpec, parse_presort_exp
from ..exceptions import FugueWorkflowCompileValidationError, FugueWorkflowRuntimeValidationError
from ..schema import Schema
from ._shared import comment_block_above

_COMPILE_RULES = {"partitionby_has", "partitionby_is", "presort_has", "presort_is"}
_RUNTIME_RULES = {"input_has", "input_is"}
ALL_RULES = _COMPILE_RULES | _RUNTIME_RULES


def parse_validation_rules_from_comment(func: Any) -> Dict[str, Any]:
    rules: Dict[str, Any] = {}
    for body in comment_block_above(func):
        for rule in ALL_RULES:
            if body.startswith(rule + ":"):
                rules[rule] = body[len(rule) + 1 :].strip()
    return rules


def to_validation_rules(params: Dict[str, Any]) -> Dict[str, Any]:
    for k in params:
        if k not in ALL_RULES:
            raise NotImplementedError(f"{k} is not a valid validation rule")
    return dict(params)


def _names(v: Any) -> list:
    return [x.strip() for x in (v.split(",") if isinstance(v, str) else v)]


def validate_partition_spec(spec: PartitionSpec, rules: Dict[str, Any]) -> None:
    for k, v in rules.items():
        if k == "partitionby_has":
            missing = [x for x in _names(v) if x not in spec.partition_by]
            if len(missing) > 0:
                raise FugueWorkflowCompileValidationError(
                    f"partition by must contain {missing}, got {spec.partition_by}"
                )
        elif k == "partitionby_is":
            if sorted(_names(v)) != sorted(spec.partition_by):
                raise FugueWorkflowCompileValidationError(
                    f"partition by must be {_names(v)}, got {spec.partition_by}"
                )
        elif k == "presort_has":
            for name, asc in parse_presort_exp(v).items():
                if name not in spec.presort or spec.presort[name] != asc:
                    raise FugueWorkflowCompileValidationError(
                        f"presort must contain {name} {'asc' if asc else 'desc'}"
                    )
        elif k == "presort_is":
            need = parse_presort_exp(v)
            if list(need.items()) != list(spec.presort.items()):
                raise FugueWorkflowCompileValidationError(
                    f"presort must be {dict(need)}, got {dict(spec.presort)}"
                )


def validate_input_schema(schema: Schema, rules: Dict[str, Any]) -> None:
    for k, v in rules.items():
        if k == "input_has":
            for item in _names(v):
                if item not in schema:
                    raise FugueWorkflowRuntimeValidationError(
                        f"input schema must contain {item}, got {schema}"
                    )
        elif k == "input_is":
            try:
                expected = Schema(v)
            except Exception as e:
                raise FugueWorkflowCompileValidationError(f"invalid input_is {v}") from e
            if schema != expected:
                raise FugueWorkflowRuntimeValidationError(f"input schema must be {v}, got {schema}")
