"""Typed dataclass config system — the framework's replacement for `coqpit`.

The reference (Coqui TTS) builds every config on the external ``coqpit`` package
(see Coqui TTS `TTS/config/shared_configs.py`:5).  This module provides an
equivalent, self-contained base class: nested dataclasses with dict/JSON
round-trip, attribute *and* key access, relaxed unknown-key handling (so configs
serialized by older versions still load), and CLI-style dotted overrides
(``--coqpit.model_args.hidden_channels 256``) mirroring the reference's
``--coqpit.*`` argv convention (Coqui TTS `TTS/bin/train_tts.py`:32).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Type, Union


def _strip_optional(ftype):
    """Return the concrete type inside Optional[X]/Union[X, None], else ftype."""
    origin = typing.get_origin(ftype)
    if origin is Union:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return ftype


def _serialize(value: Any) -> Any:
    if isinstance(value, Coqpit):
        return value.to_dict()
    if is_dataclass(value) and not isinstance(value, type):
        return {f.name: _serialize(getattr(value, f.name)) for f in fields(value)}
    if isinstance(value, (list, tuple)):
        return [_serialize(v) for v in value]
    if isinstance(value, dict):
        return {k: _serialize(v) for k, v in value.items()}
    if isinstance(value, Path):
        return str(value)
    if hasattr(value, "tolist"):  # numpy scalar/array
        return value.tolist()
    return value


def _deserialize(value: Any, ftype: Any) -> Any:
    """Best-effort reconstruction of `value` as `ftype` (recursive)."""
    ftype = _strip_optional(ftype)
    if value is None:
        return None
    origin = typing.get_origin(ftype)
    if origin in (list, List):
        (item_t,) = typing.get_args(ftype) or (Any,)
        return [_deserialize(v, item_t) for v in value]
    if origin in (tuple,):
        args = typing.get_args(ftype)
        if args and args[-1] is Ellipsis:
            return tuple(_deserialize(v, args[0]) for v in value)
        if args:
            return tuple(_deserialize(v, t) for v, t in zip(value, args))
        return tuple(value)
    if origin in (dict, Dict):
        args = typing.get_args(ftype)
        val_t = args[1] if len(args) == 2 else Any
        return {k: _deserialize(v, val_t) for k, v in value.items()}
    if isinstance(ftype, type) and issubclass(ftype, Coqpit) and isinstance(value, dict):
        return ftype.from_dict(value)
    if isinstance(ftype, type) and is_dataclass(ftype) and isinstance(value, dict):
        return ftype(**value)
    if ftype in (int, float, str, bool) and value is not None:
        try:
            if ftype is bool and isinstance(value, str):
                return value.lower() in ("1", "true", "yes", "on")
            return ftype(value)
        except (TypeError, ValueError):
            return value
    return value


def _coerce_like(value: str, current: Any) -> Any:
    """Coerce a CLI string to the type of the current value."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (list, tuple, dict)) or current is None:
        try:
            return json.loads(value)
        except (json.JSONDecodeError, ValueError):
            return value
    return value


@dataclass
class Coqpit:
    """Base class for all configs: nested dataclass with dict-like access."""

    # ---- dict-like access -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def __iter__(self):
        return iter(f.name for f in fields(self))

    def __len__(self) -> int:
        return len(fields(self))

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in fields(self)]

    def items(self):
        return [(f.name, getattr(self, f.name)) for f in fields(self)]

    def has(self, key: str) -> bool:
        return key in self

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {f.name: _serialize(getattr(self, f.name)) for f in fields(self)}

    @classmethod
    def from_dict(cls: Type["Coqpit"], data: Dict[str, Any]) -> "Coqpit":
        """Build an instance, ignoring unknown keys and recursing into nested configs."""
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in fields(cls):
            if f.name in data:
                kwargs[f.name] = _deserialize(data[f.name], hints.get(f.name, Any))
        obj = cls(**kwargs)
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=4, default=str)

    def save_json(self, path: str) -> None:
        Path(path).write_text(self.to_json(), encoding="utf-8")

    @classmethod
    def load_json(cls, path: str) -> "Coqpit":
        text = Path(path).read_text(encoding="utf-8")
        return cls.from_dict(json.loads(text))

    # ---- updates ----------------------------------------------------------
    def update(self, data: Dict[str, Any], allow_new: bool = False) -> None:
        hints = typing.get_type_hints(type(self))
        for key, value in data.items():
            if not hasattr(self, key) and not allow_new:
                continue
            current = getattr(self, key, None)
            if isinstance(current, Coqpit) and isinstance(value, dict):
                current.update(value, allow_new=allow_new)
            else:
                setattr(self, key, _deserialize(value, hints.get(key, Any)))

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        """Set a nested field via ``a.b.c`` path, coercing string values."""
        parts = dotted_key.split(".")
        obj: Any = self
        for part in parts[:-1]:
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        leaf = parts[-1]
        current = obj[leaf] if isinstance(obj, dict) else getattr(obj, leaf, None)
        new = _coerce_like(value, current) if isinstance(value, str) else value
        if isinstance(obj, dict):
            obj[leaf] = new
        else:
            setattr(obj, leaf, new)

    def parse_args(self, argv: Optional[List[str]] = None, arg_prefix: str = "coqpit") -> List[str]:
        """Consume ``--coqpit.x.y value`` (or ``--coqpit.x.y=value``) args.

        Returns argv entries that were NOT consumed, mirroring the reference's
        relaxed override parser (Coqui TTS `TTS/bin/train_tts.py`:32-44).
        """
        if argv is None:
            return []
        rest: List[str] = []
        i = 0
        prefix = f"--{arg_prefix}."
        while i < len(argv):
            arg = argv[i]
            if arg.startswith(prefix):
                body = arg[len(prefix):]
                if "=" in body:
                    key, value = body.split("=", 1)
                    i += 1
                else:
                    key = body
                    if i + 1 >= len(argv):
                        raise ValueError(f"Missing value for override {arg}")
                    value = argv[i + 1]
                    i += 2
                self.set_dotted(key, value)
            else:
                rest.append(arg)
                i += 1
        return rest

    # ---- validation hook --------------------------------------------------
    def check_values(self) -> None:  # pragma: no cover - subclasses override
        pass

    def copy(self):
        return type(self).from_dict(self.to_dict())


def check_argument(
    name: str,
    c: Dict[str, Any],
    restricted: bool = False,
    min_val: Optional[float] = None,
    max_val: Optional[float] = None,
    enum_list: Optional[list] = None,
    allow_none: bool = True,
) -> None:
    """Validate a config dict entry (mirrors coqpit.check_argument semantics)."""
    if name not in c or c[name] is None:
        if restricted and not allow_none:
            raise ValueError(f" [!] {name} must be defined in the config.")
        return
    val = c[name]
    if min_val is not None and val < min_val:
        raise ValueError(f" [!] {name}={val} is smaller than min {min_val}")
    if max_val is not None and val > max_val:
        raise ValueError(f" [!] {name}={val} is larger than max {max_val}")
    if enum_list is not None and str(val).lower() not in enum_list:
        raise ValueError(f" [!] {name}={val} not in allowed values {enum_list}")
