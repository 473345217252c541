"""The controls of the benchmark's comparison: the plain reference computed
one precision below what a configuration states, the step that would tempt a
later change. Each rounds the operands of every product and convolution of
the towers and keeps the sums in float32, as the hardware's lower-precision
paths do; everything between the products stays float32.

- ``FP8``: float8 e4m3 with one scale a tensor (its largest magnitude onto
  448), below bfloat16;
- ``INT4``: symmetric int4 codes (-7..7), one scale a row of the left operand
  and one a column of the right, below int8 (the W8A8 layout at 4 bits);
- ``TF32``: a 10-bit mantissa, rounded to nearest even, below float32 with
  TF32 off."""

from __future__ import annotations

import torch

from .clip_ref import Numerics

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _int4(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(t / scale), -7, 7) * scale


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest value with a 10-bit mantissa (ties to even)."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _through(q, t: torch.Tensor) -> torch.Tensor:
    """``q(t)`` forward; the gradient passes straight through, so that a
    training step under a control still reaches its leaves."""
    return t + (q(t) - t).detach()


class FP8(Numerics):
    name = "fp8"

    def operands(self, a, b):
        return _through(_fp8, a), _through(_fp8, b)

    def conv_operands(self, x, w):
        return _through(_fp8, x), _through(_fp8, w)


class INT4(Numerics):
    name = "int4"

    def operands(self, a, b):
        return (_through(lambda t: _int4(t, -1), a), _through(lambda t: _int4(t, -2), b))

    def conv_operands(self, x, w):
        return (_through(lambda t: _int4(t, -3), x),
                _through(lambda t: _int4(t.reshape(t.shape[0], -1), -1).reshape(t.shape), w))


class TF32(Numerics):
    name = "tf32"

    def operands(self, a, b):
        return _through(tf32_round, a), _through(tf32_round, b)

    def conv_operands(self, x, w):
        return _through(tf32_round, x), _through(tf32_round, w)


CONTROLS = {"fp8": FP8(), "int4": INT4(), "tf32": TF32()}
