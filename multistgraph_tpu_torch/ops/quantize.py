"""Weight-only quantization for the serving path.

Counterpart of multistgraph_tpu/ops/quantize.py, over a model's
parameters only, never its buffers (SparseATGCN's graph arrays are
buffers):

  * ``int8``: per-tensor symmetric absmax. A parameter of at least
    ``min_size`` elements is stored as int8 levels
    ``clip(round(a / scale), -127, 127)`` (``torch.round`` rounds half to
    even, as ``jnp.round`` does) with one f32 scale
    ``max(absmax, 1e-12) / 127``; smaller ones (biases, vectors) stay f32;
  * ``bfloat16``: a cast of every float parameter.

``dequantize_params`` is the inverse, run inside the service's forward (and
so inside each bucket's CUDA graph): what stays resident is the quantized
copy. Each entry maps one parameter name to one tensor, or to
``{"q8": levels, "scale": scale}``; with the JAX package's parameters
carried across one leaf to one tensor, the levels and scales are JAX's bit
for bit (absmax does not change under the layout transposes).
"""

from typing import Dict, Mapping

import torch

__all__ = ["quantize_params", "dequantize_params", "quantized_nbytes"]

_QKEY = "q8"  # the levels of a quantized entry


def _is_quantized(entry) -> bool:
    return isinstance(entry, dict) and _QKEY in entry


def quantize_params(params: Mapping[str, torch.Tensor], mode: str = "int8", min_size: int = 256) -> Dict:
    """{name: tensor} -> {name: tensor or {"q8": int8, "scale": f32 0-d}}."""
    if mode in ("bf16", "bfloat16"):
        return {name: a.detach().to(torch.bfloat16) if a.is_floating_point() else a.detach()
                for name, a in params.items()}
    if mode != "int8":
        raise ValueError("unknown quantization mode %r" % (mode,))
    out = {}
    for name, a in params.items():
        a = a.detach()
        if not a.is_floating_point() or a.numel() < min_size:
            out[name] = a
            continue
        a = a.float()
        scale = torch.clamp_min(a.abs().max(), 1e-12) / 127.0
        out[name] = {_QKEY: torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8), "scale": scale}
    return out


def dequantize_params(qparams: Mapping, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of quantize_params: every float entry back in `dtype`."""
    out = {}
    for name, entry in qparams.items():
        if _is_quantized(entry):
            out[name] = (entry[_QKEY].to(dtype) * entry["scale"]).to(dtype)
        elif entry.is_floating_point() and entry.dtype != dtype:
            out[name] = entry.to(dtype)
        else:
            out[name] = entry
    return out


def quantized_nbytes(qparams: Mapping) -> int:
    """Stored bytes of a (possibly quantized) parameter dict."""
    total = 0
    for entry in qparams.values():
        for t in (entry.values() if _is_quantized(entry) else (entry,)):
            total += t.numel() * t.element_size()
    return total
