"""Math-expression evaluator (host-side, plain Python floats).

Port of wave_tracer_tpu/core/expr.py, which `AnalyticSpectrum` evaluates
its expression with: a small recursive-descent parser (tinyexpr-style
syntax, as the scene files' attribute values use).

Grammar (loosest-binding first):
    or     := and ('||' and)*
    and    := cmp ('&&' cmp)*
    cmp    := add (('=='|'!='|'<='|'>='|'<'|'>') add)?
    add    := mul (('+'|'-') mul)*
    mul    := unary (('*'|'/'|'%') unary)*
    unary  := ('-'|'+'|'!') unary | power
    power  := atom ('^' unary)?
    atom   := NUMBER | 'true' | 'false' | 'pi' | 'e' | IDENT '(' args ')'
            | '(' or ')'
"""

from __future__ import annotations

import math
import re

_FUNCS = {
    "abs": abs, "acos": math.acos, "asin": math.asin, "atan": math.atan,
    "atan2": math.atan2, "ceil": math.ceil, "cos": math.cos,
    "cosh": math.cosh, "exp": math.exp, "floor": math.floor,
    "ln": math.log, "log": math.log10, "log10": math.log10,
    "log2": math.log2, "max": max, "min": min, "pow": math.pow,
    "sin": math.sin, "sinh": math.sinh, "sqrt": math.sqrt,
    "tan": math.tan, "tanh": math.tanh, "fmod": math.fmod,
    "round": round, "sign": lambda x: (x > 0) - (x < 0),
}

_CONSTS = {"pi": math.pi, "e": math.e, "true": 1.0, "false": 0.0,
           "inf": math.inf, "nan": math.nan}

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>==|!=|<=|>=|&&|\|\||[-+*/%^()!<>,]))")


class ExprError(ValueError):
    pass


def _tokenize(s: str):
    pos, toks = 0, []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise ExprError(f"bad token in expression at {s[pos:]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            toks.append(("num", float(m.group("num"))))
        elif m.lastgroup == "ident":
            toks.append(("ident", m.group("ident")))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("end", None))
    return toks


class _Parser:
    def __init__(self, toks, variables):
        self.toks = toks
        self.i = 0
        self.vars = variables or {}

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_op(self, *ops):
        kind, val = self.peek()
        if kind == "op" and val in ops:
            self.next()
            return val
        return None

    def parse_or(self):
        v = self.parse_and()
        while self.accept_op("||"):
            rhs = self.parse_and()
            v = 1.0 if (v != 0.0 or rhs != 0.0) else 0.0
        return v

    def parse_and(self):
        v = self.parse_cmp()
        while self.accept_op("&&"):
            rhs = self.parse_cmp()
            v = 1.0 if (v != 0.0 and rhs != 0.0) else 0.0
        return v

    def parse_cmp(self):
        v = self.parse_add()
        op = self.accept_op("==", "!=", "<=", ">=", "<", ">")
        if op:
            rhs = self.parse_add()
            res = {"==": v == rhs, "!=": v != rhs, "<=": v <= rhs,
                   ">=": v >= rhs, "<": v < rhs, ">": v > rhs}[op]
            return 1.0 if res else 0.0
        return v

    def parse_add(self):
        v = self.parse_mul()
        while True:
            op = self.accept_op("+", "-")
            if not op:
                return v
            rhs = self.parse_mul()
            v = v + rhs if op == "+" else v - rhs

    def parse_mul(self):
        v = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return v
            rhs = self.parse_unary()
            if op == "*":
                v = v * rhs
            elif op == "/":
                v = v / rhs
            else:
                v = math.fmod(v, rhs)

    def parse_unary(self):
        op = self.accept_op("-", "+", "!")
        if op == "-":
            return -self.parse_unary()
        if op == "+":
            return self.parse_unary()
        if op == "!":
            return 0.0 if self.parse_unary() != 0.0 else 1.0
        return self.parse_power()

    def parse_power(self):
        v = self.parse_atom()
        if self.accept_op("^"):
            return v ** self.parse_unary()
        return v

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return val
        if kind == "ident":
            if self.accept_op("("):
                args = []
                if not self.accept_op(")"):
                    args.append(self.parse_or())
                    while self.accept_op(","):
                        args.append(self.parse_or())
                    if not self.accept_op(")"):
                        raise ExprError("expected ')'")
                fn = _FUNCS.get(val)
                if fn is None:
                    raise ExprError(f"unknown function {val!r}")
                return float(fn(*args))
            if val in self.vars:
                return float(self.vars[val])
            if val in _CONSTS:
                return _CONSTS[val]
            raise ExprError(f"unknown identifier {val!r}")
        if kind == "op" and val == "(":
            v = self.parse_or()
            if not self.accept_op(")"):
                raise ExprError("expected ')'")
            return v
        raise ExprError(f"unexpected token {val!r}")


def evaluate(expression: str, variables: dict | None = None) -> float:
    """Evaluate a scalar math expression; booleans are 1.0/0.0."""
    p = _Parser(_tokenize(expression), variables)
    v = p.parse_or()
    if p.peek()[0] != "end":
        raise ExprError(f"trailing input in {expression!r}")
    return v


def evaluate_bool(expression: str, variables: dict | None = None) -> bool:
    s = expression.strip().lower()
    if s == "true":
        return True
    if s == "false":
        return False
    return evaluate(expression, variables) != 0.0
