"""Lua configuration-file loader (counterpart of
hectorgrapher_tpu/common/lua_config.py).

The reference configures everything through Lua files evaluated by a real
Lua 5.2 interpreter into a ``LuaParameterDictionary`` (ref:
cartographer/common/lua_parameter_dictionary.{h,cc},
cartographer/common/configuration_file_resolver.cc:28-54, defaults in
configuration_files/*.lua).  A user switching from the reference carries
``.lua`` config files, so this module evaluates the Lua *subset* those
files actually use — without a Lua dependency:

- ``include "file.lua"`` resolved against a list of configuration
  directories, first match wins (configuration_file_resolver.cc:47-54);
- global and ``local`` assignments, dotted/indexed lvalues
  (``POSE_GRAPH.constraint_builder.min_score = 0.7``);
- table constructors with nested tables, named/array fields, and
  *reference semantics* (``pose_graph = POSE_GRAPH`` aliases the table, so
  later mutation of ``POSE_GRAPH`` is visible through ``MAP_BUILDER`` —
  exactly as in Lua);
- numbers (int/float/hex/exponent), strings, booleans, ``nil``;
- operators ``or and  == ~= < <= > >=  ..  + -  * / % // ^`` and unary
  ``- not``, with Lua precedence;
- the ``math`` library surface used by the configs (``rad``, ``deg``,
  ``pi``, ``sqrt``, ``floor``, ``ceil``, ``abs``, ``min``, ``max``,
  ``huge``, ``pow``, ``log``, ``exp``), ``tonumber``/``tostring``, and a
  stub ``os.getenv``;
- ``return expr`` (the cartographer_ros ``return options`` convention).

The result is plain Python dicts; ``map_builder_options_from_lua``
converts them into the typed config tree of `common.config`, with the
same unknown-key strictness as the reference's unused-key check. An
optional sub-config left at None (``overlapping_submaps_trimmer_2d``) is
built by ``config.merge`` from its table, its unknown keys rejected.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from . import config as config_mod

__all__ = [
    "LuaError",
    "run_lua",
    "load_lua_file",
    "resolve_file",
    "map_builder_options_from_lua",
    "load_map_builder_options",
    "LuaMapBuilderConfig",
]


class LuaError(ValueError):
    """Raised on a parse or evaluation error in a config file."""


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<longcomment>--\[(?P<ceq>=*)\[.*?\](?P=ceq)\])
  | (?P<comment>--[^\n]*)
  | (?P<number>0[xX][0-9a-fA-F]+|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>\.\.|==|~=|<=|>=|//|[{}=,.\[\]()+\-*/%^<>\#;:])
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {
    "true",
    "false",
    "nil",
    "not",
    "and",
    "or",
    "local",
    "return",
    "include",
    "function",
    "end",
    "if",
    "then",
    "else",
    "elseif",
    "while",
    "do",
    "for",
}

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"', "'": "'", "a": "\a", "b": "\b", "f": "\f", "v": "\v", "0": "\0", "\n": "\n"}


class _Token:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind: str, value: Any, line: int):
        self.kind = kind
        self.value = value
        self.line = line

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Token({self.kind}, {self.value!r}, line {self.line})"


def _tokenize(src: str, filename: str) -> List[_Token]:
    tokens: List[_Token] = []
    pos = 0
    line = 1
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise LuaError(f"{filename}:{line}: unexpected character {src[pos]!r}")
        text = m.group(0)
        line += text.count("\n")
        pos = m.end()
        if m.lastgroup in ("ws", "comment", "longcomment", "ceq"):
            continue
        kind = m.lastgroup
        if kind == "number":
            if text.lower().startswith("0x"):
                value: Any = int(text, 16)
            elif re.fullmatch(r"\d+", text):
                value = int(text)
            else:
                value = float(text)
            tokens.append(_Token("number", value, line))
        elif kind == "name":
            if text in _KEYWORDS:
                tokens.append(_Token(text, text, line))
            else:
                tokens.append(_Token("name", text, line))
        elif kind == "string":
            body = text[1:-1]
            out = []
            i = 0
            while i < len(body):
                c = body[i]
                if c == "\\" and i + 1 < len(body):
                    nxt = body[i + 1]
                    out.append(_ESCAPES.get(nxt, nxt))
                    i += 2
                else:
                    out.append(c)
                    i += 1
            tokens.append(_Token("string", "".join(out), line))
        else:
            tokens.append(_Token(text, text, line))
    tokens.append(_Token("<eof>", None, line))
    return tokens


# ---------------------------------------------------------------------------
# Builtins
# ---------------------------------------------------------------------------


def _lua_tonumber(x=None):
    if x is None or isinstance(x, (int, float)):
        return x
    try:
        s = str(x).strip()
        if s.lower().startswith("0x"):
            return int(s, 16)
        f = float(s)
        return int(f) if f.is_integer() and ("." not in s and "e" not in s.lower()) else f
    except ValueError:
        return None


def _lua_tostring(x=None):
    if x is None:
        return "nil"
    if isinstance(x, bool):
        return "true" if x else "false"
    return str(x)


def _make_builtins() -> Dict[str, Any]:
    return {
        "math": {
            "rad": math.radians,
            "deg": math.degrees,
            "pi": math.pi,
            "sqrt": math.sqrt,
            "floor": math.floor,
            "ceil": math.ceil,
            "abs": abs,
            "min": min,
            "max": max,
            "huge": math.inf,
            "pow": lambda a, b: a ** b,
            "log": math.log,
            "exp": math.exp,
        },
        "os": {"getenv": lambda name=None: os.environ.get(name) if name else None},
        "string": {"format": lambda fmt, *args: _lua_format(fmt, *args)},
        "tonumber": _lua_tonumber,
        "tostring": _lua_tostring,
        "print": lambda *args: None,
    }


def _lua_format(fmt: str, *args) -> str:
    # Lua's string.format is printf-like; Python's % handles the used subset.
    return fmt % args


# ---------------------------------------------------------------------------
# Parser / evaluator
# ---------------------------------------------------------------------------


class _Interp:
    """Single-pass parse-and-evaluate interpreter (configs are straight-line
    code, so no AST is needed)."""

    def __init__(self, globals_: Dict[str, Any], config_dirs: Sequence[str], filename: str):
        self.globals = globals_
        self.config_dirs = list(config_dirs)
        self.filename = filename
        self.tokens: List[_Token] = []
        self.i = 0
        self.locals: Dict[str, Any] = {}
        self.returned: Any = None
        self.has_returned = False

    # -- token helpers ------------------------------------------------------

    def _peek(self) -> _Token:
        return self.tokens[self.i]

    def _next(self) -> _Token:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def _expect(self, kind: str) -> _Token:
        tok = self._next()
        if tok.kind != kind:
            raise LuaError(f"{self.filename}:{tok.line}: expected {kind!r}, got {tok.kind!r}")
        return tok

    def _accept(self, kind: str) -> Optional[_Token]:
        if self._peek().kind == kind:
            return self._next()
        return None

    # -- run ----------------------------------------------------------------

    def run(self, src: str) -> Any:
        self.tokens = _tokenize(src, self.filename)
        self.i = 0
        while self._peek().kind != "<eof>" and not self.has_returned:
            self._statement()
        return self.returned

    # -- statements ---------------------------------------------------------

    def _statement(self) -> None:
        tok = self._peek()
        if tok.kind == ";":
            self._next()
            return
        if tok.kind == "include":
            self._next()
            name_tok = self._expect("string")
            self._do_include(name_tok.value)
            return
        if tok.kind == "return":
            self._next()
            self.returned = self._expression()
            self.has_returned = True
            return
        if tok.kind == "local":
            self._next()
            name = self._expect("name").value
            self._expect("=")
            self.locals[name] = self._expression()
            return
        if tok.kind == "name":
            self._assignment_or_call()
            return
        raise LuaError(f"{self.filename}:{tok.line}: unsupported statement starting with {tok.kind!r}")

    def _assignment_or_call(self) -> None:
        # Parse the prefix; decide between assignment target and a bare call.
        name_tok = self._expect("name")
        name = name_tok.value
        # Resolve the base container lazily so `X = ...` can create globals.
        path: List[Any] = []  # keys applied to the base
        called = False
        value_so_far: Any = None
        resolved = False

        def resolve_base():
            nonlocal value_so_far, resolved
            if not resolved:
                value_so_far = self._lookup(name, name_tok.line)
                resolved = True

        while True:
            tok = self._peek()
            if tok.kind == ".":
                self._next()
                key = self._expect("name").value
                path.append(key)
            elif tok.kind == "[":
                self._next()
                key = self._expression()
                self._expect("]")
                path.append(key)
            elif tok.kind == "(" or tok.kind == "string" or tok.kind == "{":
                # function call statement, e.g. print("x")
                resolve_base()
                fn = value_so_far
                for key in path:
                    fn = _index(fn, key, self.filename, tok.line)
                self._call(fn, tok.line)
                called = True
                break
            else:
                break

        if called:
            return
        eq = self._expect("=")
        value = self._expression()
        if not path:
            if name in self.locals:
                self.locals[name] = value
            else:
                self.globals[name] = value
            return
        resolve_base()
        container = value_so_far
        for key in path[:-1]:
            container = _index(container, key, self.filename, eq.line)
        if not isinstance(container, dict):
            raise LuaError(f"{self.filename}:{eq.line}: cannot assign into non-table value")
        container[_normkey(path[-1])] = value

    def _do_include(self, name: str) -> None:
        path = resolve_file(name, self.config_dirs)
        with open(path, "r") as f:
            src = f.read()
        sub = _Interp(self.globals, self.config_dirs, path)
        sub.run(src)

    # -- expressions (Lua precedence climbing) ------------------------------

    def _expression(self) -> Any:
        return self._or_expr()

    def _skip_operand(self, parse) -> None:
        """Advance past an operand whose VALUE is dead (short-circuited):
        Lua never evaluates it, so errors it would raise (e.g. indexing a
        nil in the guard idiom `t and t.field or default`) must not
        surface. Side-effect-free parsing is assumed — reference configs
        only use field accesses and literals in these positions."""
        try:
            parse()
        except LuaError:
            pass

    def _or_expr(self) -> Any:
        value = self._and_expr()
        while self._accept("or"):
            if _truthy(value):
                self._skip_operand(self._and_expr)  # short-circuit
            else:
                value = self._and_expr()
        return value

    def _and_expr(self) -> Any:
        value = self._cmp_expr()
        while self._accept("and"):
            if _truthy(value):
                value = self._cmp_expr()
            else:
                self._skip_operand(self._cmp_expr)  # short-circuit
        return value

    def _cmp_expr(self) -> Any:
        value = self._concat_expr()
        while self._peek().kind in ("==", "~=", "<", "<=", ">", ">="):
            op = self._next().kind
            rhs = self._concat_expr()
            if op == "==":
                value = value == rhs
            elif op == "~=":
                value = value != rhs
            elif op == "<":
                value = value < rhs
            elif op == "<=":
                value = value <= rhs
            elif op == ">":
                value = value > rhs
            else:
                value = value >= rhs
        return value

    def _concat_expr(self) -> Any:
        value = self._add_expr()
        if self._peek().kind == "..":
            self._next()
            rhs = self._concat_expr()  # right associative
            value = _lua_tostring(value) + _lua_tostring(rhs)
        return value

    def _add_expr(self) -> Any:
        value = self._mul_expr()
        while self._peek().kind in ("+", "-"):
            op = self._next().kind
            rhs = self._mul_expr()
            value = value + rhs if op == "+" else value - rhs
        return value

    def _mul_expr(self) -> Any:
        value = self._unary_expr()
        while self._peek().kind in ("*", "/", "%", "//"):
            op = self._next().kind
            rhs = self._unary_expr()
            if op == "*":
                value = value * rhs
            elif op == "/":
                value = value / rhs
            elif op == "//":
                value = value // rhs
            else:
                value = value % rhs
        return value

    def _unary_expr(self) -> Any:
        tok = self._peek()
        if tok.kind == "-":
            self._next()
            return -self._unary_expr()
        if tok.kind == "not":
            self._next()
            return not _truthy(self._unary_expr())
        return self._pow_expr()

    def _pow_expr(self) -> Any:
        value = self._postfix_expr()
        if self._peek().kind == "^":
            self._next()
            rhs = self._unary_expr()  # right associative, binds tighter than unary on the right
            value = value ** rhs
        return value

    def _postfix_expr(self) -> Any:
        tok = self._next()
        if tok.kind == "number" or tok.kind == "string":
            value: Any = tok.value
        elif tok.kind == "true":
            value = True
        elif tok.kind == "false":
            value = False
        elif tok.kind == "nil":
            value = None
        elif tok.kind == "{":
            value = self._table()
        elif tok.kind == "(":
            value = self._expression()
            self._expect(")")
        elif tok.kind == "name":
            value = self._lookup(tok.value, tok.line)
        else:
            raise LuaError(f"{self.filename}:{tok.line}: unexpected token {tok.kind!r} in expression")

        while True:
            nxt = self._peek()
            if nxt.kind == ".":
                self._next()
                key = self._expect("name").value
                value = _index(value, key, self.filename, nxt.line)
            elif nxt.kind == "[":
                self._next()
                key = self._expression()
                self._expect("]")
                value = _index(value, key, self.filename, nxt.line)
            elif nxt.kind in ("(", "string", "{"):
                value = self._call(value, nxt.line)
            else:
                return value

    def _call(self, fn: Any, line: int) -> Any:
        tok = self._next()
        args: List[Any] = []
        if tok.kind == "string":
            args = [tok.value]
        elif tok.kind == "{":
            args = [self._table()]
        elif tok.kind == "(":
            if self._peek().kind != ")":
                args.append(self._expression())
                while self._accept(","):
                    args.append(self._expression())
            self._expect(")")
        else:  # pragma: no cover - guarded by caller
            raise LuaError(f"{self.filename}:{line}: malformed call")
        if not callable(fn):
            raise LuaError(f"{self.filename}:{line}: attempt to call a non-function value")
        return fn(*args)

    def _table(self) -> Dict[Any, Any]:
        """Parse a table constructor; '{' already consumed."""
        table: Dict[Any, Any] = {}
        array_index = 1
        while True:
            tok = self._peek()
            if tok.kind == "}":
                self._next()
                return table
            if tok.kind == "[":
                self._next()
                key = self._expression()
                self._expect("]")
                self._expect("=")
                table[_normkey(key)] = self._expression()
            elif tok.kind == "name" and self.tokens[self.i + 1].kind == "=":
                self._next()
                key = tok.value
                self._expect("=")
                table[key] = self._expression()
            else:
                table[array_index] = self._expression()
                array_index += 1
            if not (self._accept(",") or self._accept(";")):
                self._expect("}")
                return table

    def _lookup(self, name: str, line: int) -> Any:
        if name in self.locals:
            return self.locals[name]
        if name in self.globals:
            return self.globals[name]
        raise LuaError(f"{self.filename}:{line}: undefined variable {name!r}")


def _truthy(x: Any) -> bool:
    return x is not None and x is not False


def _normkey(key: Any) -> Any:
    if isinstance(key, float) and key.is_integer():
        return int(key)
    return key


def _index(value: Any, key: Any, filename: str, line: int) -> Any:
    if isinstance(value, dict):
        key = _normkey(key)
        if key not in value:
            raise LuaError(f"{filename}:{line}: key {key!r} not found")
        return value[key]
    raise LuaError(f"{filename}:{line}: attempt to index a non-table value")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def resolve_file(basename: str, config_dirs: Sequence[str]) -> str:
    """First-match file resolution across configuration directories
    (ref: configuration_file_resolver.cc:38-54)."""
    for d in config_dirs:
        candidate = os.path.join(d, basename)
        if os.path.isfile(candidate):
            return candidate
    raise FileNotFoundError(f"configuration file {basename!r} not found in {list(config_dirs)}")


def run_lua(code: str, config_dirs: Sequence[str] = (), filename: str = "<string>") -> Tuple[Dict[str, Any], Any]:
    """Execute Lua config code; returns (globals, returned_value)."""
    globals_: Dict[str, Any] = _make_builtins()
    interp = _Interp(globals_, config_dirs, filename)
    returned = interp.run(code)
    return globals_, returned


def load_lua_file(basename: str, config_dirs: Sequence[str]) -> Tuple[Dict[str, Any], Any]:
    """Resolve and execute a Lua config file (ref: common/configuration_file_resolver.cc)."""
    path = resolve_file(basename, config_dirs)
    with open(path, "r") as f:
        code = f.read()
    return run_lua(code, config_dirs, path)


class LuaMapBuilderConfig:
    """Typed result of a reference-style Lua configuration.

    Mirrors the option wrappers the reference builds from Lua:
    ``MapBuilderOptions`` + per-trajectory wrapper options
    (collate flags, pure-localization trimmer — ref:
    mapping/proto/trajectory_builder_options.proto).
    """

    def __init__(
        self,
        map_builder: "config_mod.MapBuilderOptions",
        collate_fixed_frame: bool = True,
        collate_landmarks: bool = False,
        pure_localization_max_submaps_to_keep: Optional[int] = None,
        extra: Optional[Dict[str, Any]] = None,
    ):
        self.map_builder = map_builder
        self.collate_fixed_frame = collate_fixed_frame
        self.collate_landmarks = collate_landmarks
        self.pure_localization_max_submaps_to_keep = pure_localization_max_submaps_to_keep
        self.extra = extra or {}


def _strip_unsupported(tree: Mapping[str, Any], cls) -> Dict[str, Any]:
    """Drop keys the typed config doesn't carry, recursively; returns a new
    dict. Records nothing: callers use config.merge, which raises on
    unknown keys, so this only drops keys on request (strict=False)."""
    import dataclasses

    known = {f.name: f for f in dataclasses.fields(cls)}
    out: Dict[str, Any] = {}
    base = cls()
    for key, value in tree.items():
        if key not in known:
            continue
        current = getattr(base, key)
        if isinstance(value, Mapping) and dataclasses.is_dataclass(current):
            out[key] = _strip_unsupported(value, type(current))
        else:
            out[key] = value
    return out


def map_builder_options_from_lua(
    globals_: Mapping[str, Any],
    returned: Any = None,
    strict: bool = True,
) -> LuaMapBuilderConfig:
    """Convert evaluated Lua globals (and an optional ``return options``
    table, cartographer_ros style) into typed options.

    The reference wires MAP_BUILDER (with POSE_GRAPH inside) and
    TRAJECTORY_BUILDER (with 2D/3D blocks and collate flags) separately
    (ref: map_builder.lua, trajectory_builder.lua); here both land in one
    `MapBuilderOptions` plus wrapper fields.
    """
    source: Mapping[str, Any] = returned if isinstance(returned, Mapping) else globals_

    def pick(*names):
        for n in names:
            if isinstance(source, Mapping) and n in source:
                return source[n]
            if n in globals_:
                return globals_[n]
        return None

    map_builder = dict(pick("map_builder", "MAP_BUILDER") or {})
    trajectory_builder = dict(pick("trajectory_builder", "TRAJECTORY_BUILDER") or {})

    collate_fixed_frame = bool(trajectory_builder.pop("collate_fixed_frame", True))
    collate_landmarks = bool(trajectory_builder.pop("collate_landmarks", False))
    pure_loc = trajectory_builder.pop("pure_localization_trimmer", None)
    pure_loc_keep = int(pure_loc["max_submaps_to_keep"]) if isinstance(pure_loc, Mapping) else None

    tb2 = trajectory_builder.pop("trajectory_builder_2d", None)
    tb3 = trajectory_builder.pop("trajectory_builder_3d", None)
    extra = {k: v for k, v in trajectory_builder.items()}

    tree: Dict[str, Any] = dict(map_builder)
    if tb2 is not None:
        tree["trajectory_builder_2d"] = tb2
    if tb3 is not None:
        tree["trajectory_builder_3d"] = tb3

    cfg = config_mod.MapBuilderOptions()
    if not strict:
        tree = _strip_unsupported(tree, config_mod.MapBuilderOptions)
    cfg = config_mod.merge(cfg, tree)
    return LuaMapBuilderConfig(
        map_builder=cfg,
        collate_fixed_frame=collate_fixed_frame,
        collate_landmarks=collate_landmarks,
        pure_localization_max_submaps_to_keep=pure_loc_keep,
        extra=extra,
    )


def load_map_builder_options(
    basename: str, config_dirs: Sequence[str], strict: bool = True
) -> LuaMapBuilderConfig:
    """One-call equivalent of the reference's LoadOptions
    (ref: cartographer_ros node_options.cc pattern; resolver + Lua eval +
    option conversion)."""
    globals_, returned = load_lua_file(basename, config_dirs)
    return map_builder_options_from_lua(globals_, returned, strict=strict)
