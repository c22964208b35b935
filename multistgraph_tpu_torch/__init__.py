"""multistgraph_tpu_torch — the PyTorch and CUDA port of multistgraph_tpu.

The port grows beside the JAX package, slice by slice, and is held against
it by the tests. This slice serves MultiATGCN: config, atomic data and MTH
windowing, the multi-view graph supports, the model forward (f32, bf16 and
the int8 weight-stream path), and the bucketed predict service with its
HTTP front.

The package imports torch, numpy and scipy, and nothing of JAX, flax,
pandas or multistgraph_tpu. Entry points (``PredictService``,
``PredictService.from_experiment``, ``serve_model``, ``get_model``) run on
CUDA unless the caller passes ``device="cpu"``.

Layer map (module names mirror the JAX package):
    config/    — layered config precedence
    data/      — csv atomic readers, scalers, MTH windows, device tensors
    graph/     — Laplacians, haversine geometry, multi-view supports
    models/    — MultiATGCN as an nn.Module
    ops/       — the hand-written CUDA kernels (csrc/) and their plain twins
    serving.py — bucketed predict service + HTTP
"""

__version__ = "0.1.0"
