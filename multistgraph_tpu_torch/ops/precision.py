"""Cotangent rounding: the identity forward, a cast of the gradient backward.

Counterpart of multistgraph_tpu/ops/precision.py. Under bf16 or f16
compute JAX's transpose rules hand a stack of 16-bit activations an f32
cotangent (the f32 ``preferred_element_type`` of the products behind it),
and scan's transpose then allocates its per-step accumulator in f32; JAX places
``round_cotangent`` at SparseATGCN's per-step input stack and its
layer-output stack to keep those accumulators in the compute dtype.

PyTorch's autograd already casts every gradient to its primal's dtype, so
here the function changes no value and no buffer size. It is ported anyway,
at the same two sites of the model, so that the rounding points of the two
packages are the same and a test can show where they are.
"""

import torch

__all__ = ["round_cotangent"]


class _RoundCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def round_cotangent(x, dtype):
    """Identity on ``x``; the gradient flowing back through this point is cast
    to ``dtype`` (a torch dtype or its name, e.g. ``'bfloat16'`` or
    ``'float16'``, as JAX's ``g.astype`` takes it)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return _RoundCotangent.apply(x, dtype)
