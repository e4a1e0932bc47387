"""Equal-style variables: LAMMPS expression text -> callable (port of
lammps_plugins_tpu/api/equalvar.py).

The reference evaluates equal-style B-field components every step
(Variable::compute_equal, fix_bfield.cpp:62-81,513-519).  Inside the
port's captured step the time is a 0-d device tensor, so the text is
compiled once into a closure tree whose operations are torch ops on a
tensor and math functions on a Python float: a fix bfield component is
a callable of the 0-d tensor t (capturable), and a thermo column `v_`
is evaluated on the host row, as in the JAX package.

Grammar (the subset LAMMPS equal-style offers the reference's use case):
  expr    := term (('+' | '-') term)*
  term    := unary (('*' | '/') unary)*
  unary   := '-' unary | power
  power   := atom ('^' unary)?            (right-associative, LAMMPS pow)
  atom    := NUMBER | KEYWORD | 'PI' | v_name | func '(' expr ')'
           | '(' expr ')'
Functions: sqrt exp ln log(=log10) sin cos tan abs floor ceil.
Keywords (LAMMPS thermo keywords, Variable::evaluate): time step temp
press vol pe ke etotal.  A time-only expression evaluates from a bare
scalar; the thermo keywords need an env mapping (the thermo row).  The
compiled callable exposes `.keywords`, so a caller that has only the
time (fix bfield) rejects other keywords at set-up.  v_name references
resolve recursively through the script's variable table (cycles are an
error).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping

import torch

# LAMMPS thermo keywords available in equal-style expressions
_KEYWORDS = ("time", "step", "temp", "press", "vol", "pe", "ke", "etotal")

_TOKEN = re.compile(
    r"\s*(?:(\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"  # number
    r"|([A-Za-z_][A-Za-z_0-9]*)"                                   # name
    r"|(\*\*)"                                                     # ** == ^
    r"|([-+*/^()]))")


def _fn(torch_fn, host_fn):
    """A function on a tensor (torch op) or on a Python number (math)."""
    return lambda v: (torch_fn(v) if torch.is_tensor(v)
                      else float(host_fn(v)))


_FUNCS = {
    "sqrt": _fn(torch.sqrt, math.sqrt), "exp": _fn(torch.exp, math.exp),
    "ln": _fn(torch.log, math.log),
    "log": _fn(torch.log10, math.log10),   # LAMMPS log() is base 10
    "sin": _fn(torch.sin, math.sin), "cos": _fn(torch.cos, math.cos),
    "tan": _fn(torch.tan, math.tan), "abs": _fn(torch.abs, abs),
    "floor": _fn(torch.floor, math.floor),
    "ceil": _fn(torch.ceil, math.ceil),
}


class EqualVarError(ValueError):
    pass


def _tokenize(text: str):
    toks, i = [], 0
    while i < len(text):
        m = _TOKEN.match(text, i)
        if not m or m.end() == i:
            if text[i:].strip() == "":
                break
            raise EqualVarError(f"Bad token in equal-style expr: {text[i:]!r}")
        num, name, dstar, op = m.groups()
        if num is not None:
            toks.append(("num", float(num)))
        elif name is not None:
            toks.append(("name", name))
        elif dstar is not None:
            toks.append(("op", "^"))
        else:
            toks.append(("op", op))
        i = m.end()
    return toks


class _Parser:
    def __init__(self, toks, variables: Mapping[str, str], stack, used):
        self.toks = toks
        self.pos = 0
        self.variables = variables
        self.stack = stack
        self.used = used          # keywords referenced (shared, mutated)

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self):
        t = self.peek()
        if t is None:
            raise EqualVarError("Unexpected end of equal-style expression")
        self.pos += 1
        return t

    def expect(self, op):
        t = self.take()
        if t != ("op", op):
            raise EqualVarError(f"Expected {op!r}, got {t!r}")

    def expr(self):
        f = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            op = self.take()[1]
            g = self.term()
            if op == "+":
                f = (lambda a, b: lambda t: a(t) + b(t))(f, g)
            else:
                f = (lambda a, b: lambda t: a(t) - b(t))(f, g)
        return f

    def term(self):
        f = self.unary()
        while self.peek() in (("op", "*"), ("op", "/")):
            op = self.take()[1]
            g = self.unary()
            if op == "*":
                f = (lambda a, b: lambda t: a(t) * b(t))(f, g)
            else:
                f = (lambda a, b: lambda t: a(t) / b(t))(f, g)
        return f

    def unary(self):
        if self.peek() == ("op", "-"):
            self.take()
            f = self.unary()
            return (lambda a: lambda t: -a(t))(f)
        return self.power()

    def power(self):
        base = self.atom()
        if self.peek() == ("op", "^"):
            self.take()
            exp = self.unary()          # right-associative
            return (lambda a, b: lambda t: a(t) ** b(t))(base, exp)
        return base

    def atom(self):
        kind, val = self.take()
        if kind == "num":
            return lambda env, v=val: v
        if kind == "op" and val == "(":
            f = self.expr()
            self.expect(")")
            return f
        if kind == "name":
            if val in _KEYWORDS:
                self.used.add(val)

                def kw(env, k=val):
                    try:
                        return env[k]
                    except KeyError:
                        raise EqualVarError(
                            f"equal-style keyword {k!r} needs a thermo "
                            f"context; caller supplied only "
                            f"{sorted(env)}") from None
                return kw
            if val == "PI":
                return lambda env: math.pi
            if val in _FUNCS:
                fn = _FUNCS[val]
                self.expect("(")
                f = self.expr()
                self.expect(")")
                return (lambda g, fn=fn: lambda env: fn(g(env)))(f)
            if val.startswith("v_"):
                return _compile(val[2:], self.variables, self.stack,
                                self.used)
            raise EqualVarError(f"Unknown name {val!r} in equal-style expr")
        raise EqualVarError(f"Unexpected token {val!r}")


def _compile(name: str, variables: Mapping[str, str], stack, used):
    if name in stack:
        raise EqualVarError(f"Circular variable reference v_{name}")
    if name not in variables:
        raise EqualVarError(f"Undefined variable v_{name}")
    return _compile_text(variables[name], variables, stack | {name}, used)


def _compile_text(text: str, variables, stack, used):
    p = _Parser(_tokenize(text), variables, stack, used)
    f = p.expr()
    if p.peek() is not None:
        raise EqualVarError(
            f"Trailing tokens in equal-style expr: {text!r}")
    return f


def compile_equal(text: str, variables: Mapping[str, str] = None
                  ) -> Callable:
    """Compile equal-style text to a callable.

    The callable accepts either a bare scalar (a float or a 0-d tensor,
    bound to the `time` keyword: the fix bfield convention) or a Mapping
    env with thermo-keyword values (a thermo row plus "time").  The
    referenced keywords are exposed as `.keywords`, so that a caller
    inside the captured step can reject expressions that need per-step
    thermo values it cannot supply.
    """
    used: set = set()
    f = _compile_text(text, variables or {}, frozenset(), used)

    def call(t_or_env):
        if isinstance(t_or_env, Mapping):
            return f(t_or_env)
        return f({"time": t_or_env})

    call.keywords = frozenset(used)
    return call
