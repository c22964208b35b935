"""Layout copy: a fresh contiguous copy of a strided tensor (kernel B3).

Counterpart of multistgraph_tpu/ops/layout.py. On the TPU, an identity
Pallas call forces one full-bandwidth relayout of the encoder's per-step
input stacks at a spot chosen by the model, instead of a slow strided read
at every scan step. On the GPU the same spot matters for another reason:
the f32 encoder's ``gate_x``/``upd_x`` are the slices ``xw[..., :2H]`` and
``xw[..., 2H:]``, non-contiguous views that the scan would re-read one
strided step at a time; ``force_default_layout`` turns each into a dense
stack once.

For CUDA tensors it launches the hand-written kernel of csrc/layout_copy.cu
(which replaces multistgraph_tpu/ops/layout.py: _copy_kernel /
force_default_layout; its source note gives the bound and design); CPU
tensors take the plain version, a contiguous ``clone``. The values are
bit-identical either way. It takes 4-byte elements (the f32 stacks of the
main path), rank <= 4 and fewer than 2^31 elements, and raises on anything
else.

``force_default_layout`` is differentiable like its JAX custom VJP
(layout.py:50-64): the backward runs the same copy on the cotangent (the
reverse scan's dpre stacks, f32 on the main path), under the same checks.
Forward and backward launches are counted apart:
``force_default_layout.launches`` and ``force_default_layout.backward_launches``.
"""

import ctypes
import functools

import torch

from multistgraph_tpu_torch.ops import _cuda

_MAX_RANK = 4
_MAX_NUMEL = 2**31 - 1  # the kernel indexes with 32 bits


def force_default_layout_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a fresh contiguous copy."""
    return x.clone(memory_format=torch.contiguous_format)


@functools.cache
def _kernel():
    fn = _cuda.library("layout_copy").layout_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _copy(x: torch.Tensor, counter: str) -> torch.Tensor:
    """A fresh contiguous copy of ``x``; a kernel launch adds one to
    ``force_default_layout.<counter>``."""
    if x.dim() > _MAX_RANK:
        raise ValueError("force_default_layout takes rank <= {}, got {}".format(_MAX_RANK, x.dim()))
    if x.element_size() != 4:
        raise TypeError("force_default_layout takes 4-byte elements, got {}".format(x.dtype))
    if x.numel() > _MAX_NUMEL:
        raise ValueError("force_default_layout takes fewer than 2^31 elements, got {}".format(x.numel()))
    if x.device.type == "cpu":
        return force_default_layout_plain(x)
    if x.device.type != "cuda":
        raise ValueError("force_default_layout runs on CUDA or CPU tensors, not {}".format(x.device))
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    pad = _MAX_RANK - x.dim()
    sizes = [1] * pad + list(x.shape)
    # a size-1 dim's stride never moves the pointer; 0 keeps it out of the
    # kernel's 16-byte alignment test
    strides = [0] * pad + [s if d > 1 else 0 for d, s in zip(x.shape, x.stride())]
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), *sizes, *strides, stream)
    if rc != 0:
        raise RuntimeError("layout_copy kernel launch failed: CUDA error {}".format(rc))
    setattr(force_default_layout, counter, getattr(force_default_layout, counter) + 1)
    return y


class _ForceDefaultLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _copy(x, "launches")

    @staticmethod
    def backward(ctx, g):
        return _copy(g, "backward_launches")


def force_default_layout(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` (4-byte elements, rank <= 4),
    bit-identical to it; its gradient is the same copy of the cotangent."""
    return _ForceDefaultLayout.apply(x)


force_default_layout.launches = 0
force_default_layout.backward_launches = 0
