"""Declarative runtime parameter schema.

Mirrors the semantics of the reference's parameter system
(libgadget/utils/paramset.{c,h}): every parameter is declared with a type,
REQUIRED/OPTIONAL status, default value and help docstring; files use
``key = value  # comment`` syntax; unknown keys are errors; the full
resolved set can be dumped at startup.

Parameter *names* match gadget/params.c and genic/params.c so reference
parameter files work unchanged.
"""

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional
import re


class ParamType(Enum):
    DOUBLE = "double"
    INT = "int"
    STRING = "string"
    ENUM = "enum"


REQUIRED = "required"
OPTIONAL = "optional"


@dataclass
class ParamDecl:
    name: str
    type: ParamType
    default: Any
    required: bool
    help: str
    enum_table: Optional[Dict[str, int]] = None
    action: Optional[Callable] = None


class ParameterSet:
    def __init__(self):
        self.decls: Dict[str, ParamDecl] = {}
        self.values: Dict[str, Any] = {}
        self._set_from_file: set = set()

    # -- declaration --------------------------------------------------

    def declare_double(self, name, status, default=None, help=""):
        self._declare(name, ParamType.DOUBLE, default, status, help)

    def declare_int(self, name, status, default=None, help=""):
        self._declare(name, ParamType.INT, default, status, help)

    def declare_string(self, name, status, default=None, help=""):
        self._declare(name, ParamType.STRING, default, status, help)

    def declare_enum(self, name, enum_table, status, default=None, help=""):
        self._declare(name, ParamType.ENUM, default, status, help, enum_table)

    def _declare(self, name, type_, default, status, help, enum_table=None):
        required = status == REQUIRED
        self.decls[name] = ParamDecl(name, type_, default, required, help,
                                     enum_table)
        if not required and default is not None:
            self.values[name] = self._convert(self.decls[name], default)

    def set_action(self, name, action):
        self.decls[name].action = action

    # -- parsing ------------------------------------------------------

    def _convert(self, decl: ParamDecl, raw):
        if decl.type == ParamType.DOUBLE:
            return float(raw)
        if decl.type == ParamType.INT:
            if isinstance(raw, str):
                return int(float(raw))
            return int(raw)
        if decl.type == ParamType.STRING:
            return str(raw).strip()
        if decl.type == ParamType.ENUM:
            # Comma/whitespace-separated tokens are OR'd together, matching
            # the reference's flag-style enums (e.g. WindModel "sh03" or
            # BlackHoleFeedbackMethod "spline, mass"; paramset.c).
            s = str(raw).strip().strip('"')
            tokens = [t for t in re.split(r"[,\s]+", s) if t]
            val = 0
            for t in tokens:
                if t in decl.enum_table:
                    val |= decl.enum_table[t]
                else:
                    try:
                        val |= int(t)
                    except ValueError:
                        raise ValueError(
                            f"Value '{t}' not valid for enum {decl.name}; "
                            f"allowed: {sorted(decl.enum_table)}")
            return val
        raise ValueError(decl.type)

    def set(self, name, value):
        if name not in self.decls:
            raise KeyError(f"Unknown parameter '{name}'")
        decl = self.decls[name]
        self.values[name] = self._convert(decl, value)
        if decl.action is not None:
            decl.action(self, name)

    def parse_string(self, text: str):
        """Parse ``key = value # comment`` lines (paramset.c parser).
        Also accepts whitespace-separated ``key value`` (classic gadget)."""
        for lineno, line in enumerate(text.splitlines(), 1):
            line = re.split(r"[#%]", line, 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, _, raw = line.partition("=")
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    raise ValueError(f"line {lineno}: cannot parse '{line}'")
                key, raw = parts
            key = key.strip()
            raw = raw.strip()
            if key not in self.decls:
                raise KeyError(f"line {lineno}: unknown parameter '{key}'")
            self.set(key, raw)
            self._set_from_file.add(key)

    def parse_file(self, path: str):
        with open(path) as fh:
            self.parse_string(fh.read())
        self.validate()

    def validate(self):
        missing = [n for n, d in self.decls.items()
                   if d.required and n not in self.values]
        if missing:
            raise ValueError(f"Required parameters missing: {missing}")

    # -- access -------------------------------------------------------

    def get(self, name):
        if name not in self.decls:
            raise KeyError(f"Unknown parameter '{name}'")
        return self.values.get(name, None)

    def is_set(self, name) -> bool:
        return name in self._set_from_file

    def __getitem__(self, name):
        return self.get(name)

    def dump(self) -> str:
        """Full resolved parameter dump (params.c:409-412 analog)."""
        lines = []
        for name in sorted(self.decls):
            v = self.values.get(name, None)
            lines.append(f"{name} = {v}")
        return "\n".join(lines)
