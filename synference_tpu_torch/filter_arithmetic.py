"""Arithmetic expressions over filter columns ("F200W - F070W" colors).

Same capability as the reference's `FilterArithmeticParser`
(reference `utils.py:348-481`): tokenize an infix
expression over filter short-names, numbers and + - * / ( ), evaluate against
a dict of (batched) column arrays. Implementation is an independent
shunting-yard evaluator that works on torch tensors and numpy arrays alike.
A verbatim copy of `synference_tpu/filter_arithmetic.py`: importing that
module would pull in the JAX package's `__init__`."""

from __future__ import annotations

import re

__all__ = ["FilterArithmeticParser"]

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][\w.]*)"
    r"|(?P<op>[+\-*/()]))"
)

_PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2}


class FilterArithmeticParser:
    """Parse and evaluate filter arithmetic expressions."""

    def tokenize(self, expression: str) -> list:
        tokens, pos = [], 0
        while pos < len(expression):
            m = _TOKEN_RE.match(expression, pos)
            if m is None or m.end() == pos:
                raise ValueError(
                    f"Cannot tokenize {expression!r} at position {pos}"
                )
            if m.lastgroup == "num":
                tokens.append(float(m.group("num")))
            elif m.lastgroup == "name":
                tokens.append(m.group("name"))
            else:
                tokens.append(m.group("op"))
            pos = m.end()
        return tokens

    def _to_rpn(self, tokens: list) -> list:
        out, stack = [], []
        for tok in tokens:
            if isinstance(tok, float) or (
                isinstance(tok, str) and tok not in "+-*/()"
            ):
                out.append(tok)
            elif tok == "(":
                stack.append(tok)
            elif tok == ")":
                while stack and stack[-1] != "(":
                    out.append(stack.pop())
                if not stack:
                    raise ValueError("Unbalanced parentheses")
                stack.pop()
            else:
                while (
                    stack
                    and stack[-1] != "("
                    and _PRECEDENCE.get(stack[-1], 0) >= _PRECEDENCE[tok]
                ):
                    out.append(stack.pop())
                stack.append(tok)
        while stack:
            if stack[-1] == "(":
                raise ValueError("Unbalanced parentheses")
            out.append(stack.pop())
        return out

    def evaluate(self, tokens: list, columns: dict):
        """Evaluate tokenized expression against named column arrays.

        Filter names match either fully ("JWST/NIRCam.F200W") or by their
        short name after the last '.' ("F200W"), as the reference does.
        """
        short = {}
        for k, v in columns.items():
            short[k] = v
            short.setdefault(str(k).split(".")[-1], v)
        stack = []
        for tok in self._to_rpn(tokens):
            if isinstance(tok, float):
                stack.append(tok)
            elif tok in ("+", "-", "*", "/"):
                b = stack.pop()
                a = stack.pop()
                if tok == "+":
                    stack.append(a + b)
                elif tok == "-":
                    stack.append(a - b)
                elif tok == "*":
                    stack.append(a * b)
                else:
                    stack.append(a / b)
            else:
                if tok not in short:
                    raise KeyError(
                        f"Unknown filter/column {tok!r}; have "
                        f"{sorted(set(short))[:10]}..."
                    )
                stack.append(short[tok])
        if len(stack) != 1:
            raise ValueError("Malformed expression")
        return stack[0]

    def parse_and_evaluate(self, expression: str, columns: dict):
        return self.evaluate(self.tokenize(expression), columns)
