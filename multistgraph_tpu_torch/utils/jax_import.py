"""Carry model weights from the JAX package's flat flax names.

MultiATGCN: the port names its parameters after the reference's torch
``state_dict``; the JAX package names them flat (``l0_gate_pool``,
``end_conv_kernel``, ...). This is the port's own copy of the mapping and
the layout transposes of multistgraph_tpu/utils/torch_import.py
(``_torch_entries``): Linear kernels (in, out) become (out, in) weights
and the conv head's (t_conv*H, out) kernel becomes the Conv2d weight (out,
t_conv, 1, H).

SparseATGCN has no reference torch model, so the port keeps the JAX names
and shapes: its weights carry over as they are. The JAX 'graph'
collection is not a parameter and is not carried: both packages rebuild
it from the dataset.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from multistgraph_tpu_torch.models.sparse_atgcn import SparseATGCN


def _torch_entry(name: str, value: np.ndarray, model) -> Tuple[str, np.ndarray]:
    if isinstance(model, SparseATGCN):
        return name, value
    if name in ("node_emb", "node_vec1", "node_vec2", "weight_tsg"):
        return name, value
    if name.startswith("weight_ts_"):
        return "weight_ts." + name.split("_")[-1], value
    if name == "weights_gru":
        return "encoder.weights_gru", value
    if name == "static_gru_kernel":
        return "static_initial_gru.embd.weight", value.T
    if name == "static_gru_bias":
        return "static_initial_gru.embd.bias", value
    if name == "end_conv_kernel":
        t_conv = 1 if model.fnn_off else model.input_window
        return "end_conv.weight", value.reshape(t_conv, model.hidden_dim, -1).transpose(2, 0, 1)[:, :, None, :]
    if name == "end_conv_bias":
        return "end_conv.bias", value
    # encoder cells: l{L}_{cell}_{kind} / l{L}_res_{cell}_{kernel|bias}
    layer, rest = name[1], name[3:]
    if rest.startswith("res_"):
        cell, kind = rest[4:].split("_", 1)
        base = "encoder.res_cells.{}.{}".format(layer, cell)
        return (base + ".weight", value.T) if kind == "kernel" else (base + ".bias", value)
    cell, kind = rest.split("_", 1)
    torch_kind = {"weights_g": "weights_g", "pool": "weights_pool", "bias_pool": "bias_pool"}[kind]
    return "encoder.agru_cells.{}.{}.{}".format(layer, cell, torch_kind), value


def state_dict_from_jax(flat_params: Dict[str, np.ndarray], model) -> Dict[str, torch.Tensor]:
    """JAX flat params -> the port model's state dict (CPU float32 tensors).

    Strict both ways, like ``load_state_dict(strict=True)``: a parameter of
    the model without a JAX value, a JAX value without a parameter, or a
    shape mismatch raises.
    """
    want = model.state_dict()
    out = {}
    for name, value in flat_params.items():
        torch_name, v = _torch_entry(name, np.asarray(value, np.float32), model)
        if torch_name not in want:
            raise KeyError("JAX parameter '{}' maps to '{}', which the model does not have".format(
                name, torch_name))
        if tuple(v.shape) != tuple(want[torch_name].shape):
            raise ValueError("shape mismatch for '{}' (<- '{}'): {} vs model {}".format(
                torch_name, name, tuple(v.shape), tuple(want[torch_name].shape)))
        out[torch_name] = torch.tensor(v)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError("no JAX parameter for {}".format(missing))
    return out
