"""SparseATGCN at 50k-1M nodes: one training step's edge rate, or the serving latency.

Counterpart of tools/bench_large_graph.py (BASELINE.json configs 4-5). It
builds the synthetic spatial graph (ops/bsr.py:random_spatial_graph, in the
form ``split`` names), SparseATGCN over it with seeded random weights, and
seeded random inputs x (B, T, N_pad, 1) and targets y (B, 3, N_pad, 1),
then times either

  * training (default): Adam at 1e-3 after global-norm clipping at 5.0
    (``make_optimizer``: executor/optimizers.build_optimizer, which on the
    card gives Adam a device rate and ``capturable=True``; the clip is
    optax's rule), on the L1 loss of the forward; WARMUP untimed steps,
    then ``--iters`` steps, each synchronised and timed on the host clock.
    The metric is model edges aggregated per second: nnz edges x layers x
    T x 2 aggregations x supports x 2 (the backward) x B over the step
    time, as JAX counts them;
  * serving (``--serve``): the forward without autograd, WARMUP untimed
    calls, then ``--iters`` calls, one synchronised call at a time; the
    metric is ms per call.

On the card the timed steps and calls are replays of CUDA graphs
(executor/graphs.py), the counterpart of the JAX tool's jitted step (with
params and optimizer state donated: the graph updates them in place) and
jitted predict: the WARMUP steps or calls run eagerly on a side stream,
the allocator's cache is released (the 1M step's eager blocks and its
graph's pool would both hold ~24 GB), then one step or call is captured
and replayed. ``train_steps`` and ``serve_calls`` stay eager for callers
that time both forms. On the CPU every step is eager.

Both print one JSON line with the JAX tool's metric names
(``sparse_train_edges_per_second_<scale>[_<split>]``,
``sparse_serve_latency_<scale>[_<split>][_packed]``) and extras
(``"train_step"`` or ``"serve_call"``: "cuda graph" or "eager"), plus the
peak device memory (of the whole run, of the eager warm-up and from the
capture on) and the card's name and power limit. The 1,000,000-node
configuration of the JAX package's records is
    python -m multistgraph_tpu_torch.tools.bench_large_graph 1000000 16 12 2 band --dtype bf16 --adpadj none
and its serving form adds ``--serve --band-packed``. ``--device cpu`` runs
on the CPU (a small size, for numerics and control flow; its times are the
CPU's). Not ported: the multi-chip boundary statistics (JAX :243-255,
``--boundary-stats``, ROADMAP.md A.7) and the planted-partition family
(``--family planted``, ROADMAP.md A.6.2); each raises. The JAX tool's
--interpret and its dispatch-floor subtraction are TPU mechanisms.
"""

import argparse
import contextlib
import functools
import json
import sys
import time

import numpy as np
import torch

from multistgraph_tpu_torch.executor.graphs import StepGraph, on_side_stream
from multistgraph_tpu_torch.executor.optimizers import build_optimizer, clip_by_global_norm
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops.bsr import random_spatial_graph
from multistgraph_tpu_torch.tools import timing
from multistgraph_tpu_torch.utils.device import resolve_device

OUTPUT_WINDOW = 3
LEARNING_RATE = 1e-3
MAX_GRAD_NORM = 5.0
WARMUP = 2  # untimed steps or calls before the timed ones


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("num_nodes", nargs="?", type=int, default=49152)
    ap.add_argument("avg_degree", nargs="?", type=int, default=16)
    ap.add_argument("t_steps", nargs="?", type=int, default=8)
    ap.add_argument("batch", nargs="?", type=int, default=2)
    ap.add_argument("split", nargs="?", default="none", choices=("none", "hub", "tail", "band"))
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--family", choices=("spatial", "planted"), default="spatial")
    ap.add_argument("--adaptive-max-blocks", type=int, default=0)
    ap.add_argument("--serve", action="store_true", help="time the forward (serving) instead of training")
    ap.add_argument("--band-packed", action="store_true", help="store the band as packed rows")
    ap.add_argument("--adpadj", choices=("unidirection", "none"), default="unidirection")
    ap.add_argument("--boundary-stats", action="store_true",
                    help="multi-chip boundary fractions (not ported: ROADMAP.md A.7)")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU; the card otherwise")
    return ap.parse_args(argv)


def build_graph(cli):
    """The seeded synthetic graph in the form `split` names."""
    if cli.family == "planted":
        raise NotImplementedError("--family planted (community-reordered planted partitions) is not ported "
                                  "yet: ROADMAP.md A.6.2")
    graph, _ = random_spatial_graph(cli.num_nodes, cli.avg_degree, seed=0,
                                    split=None if cli.split == "none" else cli.split)
    return graph


def model_config(cli):
    return {"output_window": OUTPUT_WINDOW, "output_dim": 1, "rnn_units": cli.hidden, "num_layers": 2,
            "embed_dim_adj": cli.embed_dim, "adpadj": cli.adpadj, "node_conditioned": "off",
            "adaptive_max_blocks": cli.adaptive_max_blocks, "remat": True,
            "compute_dtype": "bfloat16" if cli.dtype == "bf16" else None,
            "graph_band_packed": cli.band_packed}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(cli, num_nodes, device):
    """The seeded inputs x (B, T, N_pad, 1) and targets y (B, 3, N_pad, 1)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(cli.batch, cli.t_steps, num_nodes, 1)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(cli.batch, OUTPUT_WINDOW, num_nodes, 1)).astype(np.float32)).to(device)
    return x, y


def make_optimizer(model, device):
    """Adam at LEARNING_RATE by the executor's factory: a device rate and
    ``capturable=True`` on the card, the plain form on the CPU."""
    return build_optimizer({"learner": "adam", "learning_rate": LEARNING_RATE}, model.parameters(), device=device)


def train_step(model, optimizer, x, y):
    """One step: the L1 loss, its gradients clipped at MAX_GRAD_NORM, Adam;
    returns the loss as a 0-d device tensor (no host sync)."""
    optimizer.zero_grad(set_to_none=True)
    loss = (model(x) - y).abs().mean()
    loss.backward()
    clip_by_global_norm(model.parameters(), MAX_GRAD_NORM)
    optimizer.step()
    return loss.detach()


def train_steps(model, optimizer, x, y, steps):
    """`steps` eager training steps; returns (losses as host floats read
    after the last step, seconds of each step, each ended by a
    synchronise)."""
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(train_step(model, optimizer, x, y))
        _sync(x.device)
        seconds.append(time.perf_counter() - t0)
    return [float(v) for v in losses], seconds


def serve_calls(model, x, calls):
    """`calls` eager forwards without autograd, each synchronised; returns
    (the last output, seconds of each call)."""
    seconds, out = [], None
    with torch.no_grad():
        for _ in range(calls):
            t0 = time.perf_counter()
            out = model(x)
            _sync(x.device)
            seconds.append(time.perf_counter() - t0)
    return out, seconds


def replays(graph, n):
    """`n` replays of `graph` (a captured step or call), each synchronised;
    returns what train_steps or serve_calls return: (the losses as host
    floats, read after each replay, or the last output; seconds of each
    replay)."""
    seconds, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out = graph.run()
        torch.cuda.synchronize(out.device)
        seconds.append(time.perf_counter() - t0)
        if out.dim() == 0:
            losses.append(float(out))
    return (losses if out.dim() == 0 else out), seconds


def capture(fn, device, warmup):
    """`warmup()` eagerly on a side stream, the allocator's cache released,
    then ``fn()`` captured (executor/graphs.StepGraph); returns (the graph,
    warmup's result, the peak GB allocated during the warm-up)."""
    result = on_side_stream(warmup, torch.cuda.Stream(device))
    torch.cuda.synchronize(device)
    warm_peak = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return StepGraph(fn), result, warm_peak


def run(cli, graph=None, before_timed=None):
    """Build and time as `cli` says. `graph` reuses a graph built by
    build_graph(cli); `before_timed()` is called just before the timed
    steps or calls. Returns a dict: the printed ``record``, the ``model``,
    its input ``x`` and target ``y``, the ``optimizer`` (None when
    serving), the last served ``out`` (None when training), ``graph`` (the
    captured step or call on the card, else None) and ``again``, a callable
    that runs one more step or call as the timed ones ran."""
    if cli.boundary_stats:
        raise NotImplementedError("--boundary-stats (the multi-chip boundary-exchange plan) is not ported yet: "
                                  "ROADMAP.md A.7")
    device = resolve_device(cli.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup = {}
    t0 = time.perf_counter()
    if graph is None:
        graph = build_graph(cli)
        setup["graph_seconds"] = time.perf_counter() - t0
    print("graph N={} deg={} split={} dtype={} ...".format(cli.num_nodes, cli.avg_degree, cli.split, cli.dtype),
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    model = build_sparse_atgcn(graph, model_config(cli), device=device, generator=torch.Generator().manual_seed(0))
    x, y = inputs(cli, model.num_nodes, device)
    _sync(device)
    setup["model_seconds"] = time.perf_counter() - t0
    print("set-up {}".format(json.dumps(setup)), file=sys.stderr, flush=True)

    num_sup = model.num_static + int(model.has_adaptive)
    nnz_edges = graph.nnz_edges
    scale = "1m" if cli.num_nodes >= 10 ** 6 else "{}k".format(round(cli.num_nodes / 1024))
    extras = {"num_nodes": cli.num_nodes, "split": cli.split, "dtype": cli.dtype, "t_steps": cli.t_steps,
              "batch": cli.batch, "adpadj": cli.adpadj, "nnz_edges": nnz_edges,
              "nnz_blocks": getattr(getattr(graph, "bsr", graph), "nnz_blocks", None),
              "device": str(device), "setup_seconds": setup}
    out = optimizer = step_graph = None
    if cli.serve:
        model.eval()

        def step():
            return model(x)

        def steps(n):
            return serve_calls(model, x, n)
    else:
        optimizer = make_optimizer(model, device)

        def step():
            return train_step(model, optimizer, x, y)

        def steps(n):
            return train_steps(model, optimizer, x, y, n)
    if cuda:
        # WARMUP eager steps or calls, then the timed ones are replays
        with torch.no_grad() if cli.serve else contextlib.nullcontext():
            step_graph, warm, warm_peak = capture(step, device, lambda: steps(WARMUP))
        timed = functools.partial(replays, step_graph)
    else:
        warm, timed = steps(WARMUP), steps
    if before_timed is not None:
        before_timed()
    done, seconds = timed(cli.iters)

    def again():
        timed(1)
    step_s = sum(seconds) / len(seconds)
    form = "cuda graph" if cuda else "eager"
    if cli.serve:
        out = done
        aggs = 2 * cli.t_steps * 2 * num_sup  # layers x T x (h, z*h) x supports, forward only
        extras.update({"edges_per_second": nnz_edges * aggs * cli.batch / step_s, "call_seconds": seconds,
                       "band_packed": cli.band_packed, "serve_call": form})
        record = {"metric": "sparse_serve_latency_{}{}{}".format(
            scale, "" if cli.split == "none" else "_" + cli.split, "_packed" if cli.band_packed else ""),
            "value": step_s * 1e3, "unit": "ms"}
    else:
        aggs = 2 * cli.t_steps * 2 * num_sup * 2  # x2 for the backward
        extras.update({"step_seconds": step_s, "step_seconds_each": seconds, "losses": warm[0] + done,
                       "adaptive_max_blocks": cli.adaptive_max_blocks, "hidden": cli.hidden,
                       "embed_dim_adj": cli.embed_dim, "train_step": form})
        record = {"metric": "sparse_train_edges_per_second_{}{}".format(
            scale, "" if cli.split == "none" else "_" + cli.split),
            "value": nnz_edges * aggs * cli.batch / step_s, "unit": "edges/s"}
    if cuda:
        extras["peak_memory_gb"] = max(warm_peak, torch.cuda.max_memory_allocated(device) / 1e9)
        extras["eager_warmup_peak_memory_gb"] = warm_peak
        extras["graph_peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        extras["card"] = timing.card()
    record["extras"] = extras
    return {"record": record, "model": model, "x": x, "y": y, "optimizer": optimizer, "out": out,
            "graph": step_graph, "again": again}


def main(argv=None):
    record = run(parse_args(argv))["record"]
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
