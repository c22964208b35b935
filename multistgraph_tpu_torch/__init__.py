"""multistgraph_tpu_torch — the PyTorch and CUDA port of multistgraph_tpu.

The port grows beside the JAX package, slice by slice, and is held against
it by the tests. It serves and trains MultiATGCN (config, atomic data and
MTH windowing, the multi-view graph supports, f32, bf16 and the int8
weight-stream path, the executor and evaluator, the bucketed predict
service with its HTTP front), and SparseATGCN on block-sparse graphs of the
synthetic large-graph dataset (f32; the plain BSR form and the hub, tail
and band forms, the band as per-offset planes or packed rows), and the
model zoo's first families (RNN/LSTM/GRU, FNN, Seq2Seq, AGCRN, TGCN,
STGCN, GWNET, DCRNN, ASTGCN, MSTGCN) on plain sliding windows.

The package imports torch, numpy and scipy, and nothing of JAX, flax,
pandas or multistgraph_tpu. Entry points (``PredictService``,
``PredictService.from_experiment``, ``serve_model``, ``get_model``) run on
CUDA unless the caller passes ``device="cpu"``.

Layer map (module names mirror the JAX package):
    config/    — layered config precedence
    data/      — csv atomic readers, scalers, MTH windows, device tensors,
                 the synthetic large-graph dataset
    graph/     — Laplacians, random walks, Chebyshev stacks, haversine
                 geometry, multi-view supports
    models/    — MultiATGCN, SparseATGCN and the zoo's families as nn.Modules
    ops/       — the hand-written CUDA kernels (csrc/) and their plain twins,
                 BSR, hub/tail and band graphs and the sparse products' autograd
    serving.py — bucketed predict service + HTTP
"""

__version__ = "0.1.0"
