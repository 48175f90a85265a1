"""The arithmetic a reference runs in: float64 (the reference itself), or
a precision below the one a configuration states (the control that the
comparison has to refuse): float32 for float64, and TF32 for float32
with TF32 off.

TF32 is emulated, not left to cuBLAS: every operand of a product is rounded
to TF32 (10 bits of mantissa, to nearest) and the product runs in float32
with TF32 off, as a TF32 tensor core rounds its inputs and accumulates in
float32. cuBLAS would take TF32 for some shapes and not for others
(batched matrix-vector products), so the flag alone would not say what
was computed."""

from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}
# The precision a configuration's dtype falls to in its control
BELOW = {"float64": "float32", "float32": "tf32"}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + (((bits >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding in both directions: the gradient that flows back
    through an operand is rounded too, as the backward's products take it."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest (ties
    to even)."""
    return _RoundTF32.apply(x) if x.requires_grad else _tf32(x)


class Precision:
    """Casts a reference's inputs and rounds the operands of its products."""

    def __init__(self, name: str):
        if name not in DTYPES:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = DTYPES[name]

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, as this precision's multiplier sees it."""
        return round_tf32(x) if self.name == "tf32" else x

    def einsum(self, spec: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, *(self.op(x) for x in xs))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)


def full_precision_matmuls():
    """Turn TF32 off for every product (the references compute what their
    precision says, never less)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
