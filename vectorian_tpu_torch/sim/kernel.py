"""Chainable unary operators on similarity matrices.

Reference: vectorian/sim/kernel.py — the reference mutates numpy buffers in
place from C++; here each operator is a pure tensor->tensor function applied
to the whole similarity matrix after its GEMM.
"""

from __future__ import annotations

from typing import List

import torch


class UnaryOperator:
    def kernel(self, data):
        raise NotImplementedError()

    def name(self, operand):
        raise NotImplementedError()

    @property
    def ident(self):
        return (type(self).__name__,) + tuple(
            sorted((k, v) for k, v in self.__dict__.items())
        )

    def __hash__(self):
        return hash(self.ident)

    def __eq__(self, other):
        return type(other) is type(self) and other.ident == self.ident


class RadialBasis(UnaryOperator):
    """sim = exp(-gamma * x^2) (reference sim/kernel.py:14-22)."""

    def __init__(self, gamma: float):
        self._gamma = gamma

    def kernel(self, data):
        return torch.exp(-self._gamma * torch.square(data))

    def name(self, operand):
        return f"radialbasis({operand}, {self._gamma})"


class DistanceToSimilarity(UnaryOperator):
    """sim = max(0, 1 - d) (reference sim/kernel.py:25-30)."""

    def kernel(self, data):
        return torch.clamp_min(1.0 - data, 0.0)

    def name(self, operand):
        return f"(1 - {operand})"


class Bias(UnaryOperator):
    def __init__(self, bias: float):
        self._bias = bias

    def kernel(self, data):
        return data + self._bias

    def name(self, operand):
        return f"({operand} + {self._bias})"


class Scale(UnaryOperator):
    def __init__(self, scale: float):
        self._scale = scale

    def kernel(self, data):
        return data * self._scale

    def name(self, operand):
        return f"({operand} * {self._scale})"


class Power(UnaryOperator):
    """sim = max(0, x) ** exp (reference sim/kernel.py:55-63)."""

    def __init__(self, exp: float):
        self._exp = exp

    def kernel(self, data):
        return torch.pow(torch.clamp_min(data, 0.0), self._exp)

    def name(self, operand):
        return f"({operand} ** {self._exp})"


class Threshold(UnaryOperator):
    """Zero out values <= threshold, keep others (reference kernel.py:66-76)."""

    def __init__(self, threshold: float):
        self._threshold = threshold

    def kernel(self, data):
        return torch.where(data > self._threshold, data, torch.zeros_like(data))

    def name(self, operand):
        return f"threshold({operand}, {self._threshold})"


class Kernel:
    def __init__(self, operators: List[UnaryOperator]):
        self._operators = list(operators)

    @property
    def ident(self):
        return tuple(op.ident for op in self._operators)

    def __hash__(self):
        return hash(self.ident)

    def __eq__(self, other):
        return type(other) is type(self) and other.ident == self.ident

    def __call__(self, data):
        for op in self._operators:
            data = op.kernel(data)
        return data

    def name(self, operand):
        name = operand
        for op in self._operators:
            name = op.name(name)
        return name
