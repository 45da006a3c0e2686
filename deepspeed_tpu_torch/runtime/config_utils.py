"""Config model base utilities (a copy of ``deepspeed_tpu/runtime/config_utils.py``).

The reference uses pydantic-v1 ``DeepSpeedConfigModel`` (``runtime/config_utils.py``);
here we use stdlib dataclasses with the same ergonomics: unknown keys warn instead of
fail, deprecated keys map to their replacement, and ``get_scalar_param`` mirrors the
hand-rolled reads used throughout the reference config code.
"""

import dataclasses
import json
from typing import Any, Dict, Type, TypeVar

from ..utils.logging import logger

T = TypeVar("T", bound="DeepSpeedConfigModel")


class DeepSpeedConfigModel:
    """Mixin for dataclass config blocks.

    Subclasses are ``@dataclass``-decorated; ``from_dict`` maps JSON keys to fields,
    warning (not raising) on unknown keys for forward/backward schema compatibility,
    and honoring per-field ``metadata={"deprecated": True, "new_param": "..."}``.
    """

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise TypeError(f"{cls.__name__} expects a dict, got {type(data)}")
        field_map = {f.name: f for f in dataclasses.fields(cls)}
        # alias support: field metadata can declare json_key aliases
        alias_map = {}
        for f in field_map.values():
            for alias in f.metadata.get("aliases", ()):  # type: ignore[union-attr]
                alias_map[alias] = f.name
        kwargs = {}
        for key, value in data.items():
            name = key if key in field_map else alias_map.get(key)
            if name is None:
                logger.warning(f"Config: unknown key '{key}' in {cls.__name__} — ignored")
                continue
            f = field_map[name]
            if f.metadata.get("deprecated"):
                new = f.metadata.get("new_param")
                logger.warning(
                    f"Config parameter {key} is deprecated"
                    + (f"; use {new} instead" if new else "")
                )
            sub = f.metadata.get("submodel")
            if sub is not None and isinstance(value, dict):
                value = sub.from_dict(value)
            kwargs[name] = value
        obj = cls(**kwargs)  # type: ignore[call-arg]
        obj._validate()
        return obj

    def _validate(self) -> None:
        """Subclass hook for cross-field invariants."""

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, DeepSpeedConfigModel):
                v = v.to_dict()
            out[f.name] = v
        return out

    def __repr__(self) -> str:
        return f"{type(self).__name__}({json.dumps(self.to_dict(), default=str, sort_keys=True)})"


def get_scalar_param(param_dict: Dict[str, Any], param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict: Dict[str, Any], param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict: Dict[str, Any], param_name: str, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys when parsing JSON (reference ``config_utils.py``)."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
