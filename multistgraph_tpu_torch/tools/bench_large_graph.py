"""SparseATGCN at 50k-1M nodes: one training step's edge rate, or the serving latency.

Counterpart of tools/bench_large_graph.py (BASELINE.json configs 4-5). It
builds the synthetic spatial graph (ops/bsr.py:random_spatial_graph, in the
form ``split`` names), SparseATGCN over it with seeded random weights, and
seeded random inputs x (B, T, N_pad, 1) and targets y (B, 3, N_pad, 1),
then times either

  * training (default): Adam at 1e-3 after global-norm clipping at 5.0 (the
    port's optimizer rules, executor/optimizers.py), on the L1 loss of the
    forward; WARMUP untimed steps, then ``--iters`` steps, each
    synchronised and timed on the host clock. The metric is model edges
    aggregated per second: nnz edges x layers x T x 2 aggregations x
    supports x 2 (the backward) x B over the step time, as JAX counts them;
  * serving (``--serve``): the forward without autograd, WARMUP untimed
    calls, then ``--iters`` calls, one synchronised call at a time; the
    metric is ms per call.

Both print one JSON line with the JAX tool's metric names
(``sparse_train_edges_per_second_<scale>[_<split>]``,
``sparse_serve_latency_<scale>[_<split>][_packed]``) and extras, plus the
peak device memory and the card's name and power limit. The 1,000,000-node
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
import json
import sys
import time

import numpy as np
import torch

from multistgraph_tpu_torch.executor.optimizers import clip_by_global_norm
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


def train_steps(model, optimizer, x, y, steps):
    """`steps` training steps; returns (losses as host floats read after the
    last step, seconds of each step, each ended by a synchronise)."""
    params = [p for p in model.parameters()]
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss = (model(x) - y).abs().mean()
        loss.backward()
        clip_by_global_norm(params, MAX_GRAD_NORM)
        optimizer.step()
        _sync(x.device)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.detach())
    return [float(v) for v in losses], seconds


def serve_calls(model, x, calls):
    """`calls` forwards without autograd, each synchronised; returns (the
    last output, seconds of each call)."""
    seconds, out = [], None
    with torch.no_grad():
        for _ in range(calls):
            t0 = time.perf_counter()
            out = model(x)
            _sync(x.device)
            seconds.append(time.perf_counter() - t0)
    return out, seconds


def run(cli, graph=None, before_timed=None):
    """Build and time as `cli` says. `graph` reuses a graph built by
    build_graph(cli); `before_timed()` is called just before the timed
    steps or calls. Returns a dict: the printed ``record``, the ``model``,
    its input ``x``, the last served ``out`` (None when training) and
    ``again``, a callable that runs one more step or call."""
    if cli.boundary_stats:
        raise NotImplementedError("--boundary-stats (the multi-chip boundary-exchange plan) is not ported yet: "
                                  "ROADMAP.md A.7")
    device = resolve_device(cli.device)
    if device.type == "cuda":
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
    rng = np.random.default_rng(0)
    n = model.num_nodes
    x = torch.from_numpy(rng.normal(size=(cli.batch, cli.t_steps, n, 1)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(cli.batch, OUTPUT_WINDOW, n, 1)).astype(np.float32)).to(device)
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
    out = None
    if cli.serve:
        model.eval()
        serve_calls(model, x, WARMUP)
        if before_timed is not None:
            before_timed()
        out, seconds = serve_calls(model, x, cli.iters)

        def again():
            serve_calls(model, x, 1)
        step_s = sum(seconds) / len(seconds)
        aggs = 2 * cli.t_steps * 2 * num_sup  # layers x T x (h, z*h) x supports, forward only
        extras.update({"edges_per_second": nnz_edges * aggs * cli.batch / step_s, "call_seconds": seconds,
                       "band_packed": cli.band_packed})
        record = {"metric": "sparse_serve_latency_{}{}{}".format(
            scale, "" if cli.split == "none" else "_" + cli.split, "_packed" if cli.band_packed else ""),
            "value": step_s * 1e3, "unit": "ms"}
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        warm_losses, _ = train_steps(model, optimizer, x, y, WARMUP)
        if before_timed is not None:
            before_timed()
        losses, seconds = train_steps(model, optimizer, x, y, cli.iters)

        def again():
            train_steps(model, optimizer, x, y, 1)
        step_s = sum(seconds) / len(seconds)
        aggs = 2 * cli.t_steps * 2 * num_sup * 2  # x2 for the backward
        extras.update({"step_seconds": step_s, "step_seconds_each": seconds, "losses": warm_losses + losses,
                       "adaptive_max_blocks": cli.adaptive_max_blocks, "hidden": cli.hidden,
                       "embed_dim_adj": cli.embed_dim})
        record = {"metric": "sparse_train_edges_per_second_{}{}".format(
            scale, "" if cli.split == "none" else "_" + cli.split),
            "value": nnz_edges * aggs * cli.batch / step_s, "unit": "edges/s"}
    if device.type == "cuda":
        extras["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        extras["card"] = timing.card()
    record["extras"] = extras
    return {"record": record, "model": model, "x": x, "out": out, "again": again}


def main(argv=None):
    record = run(parse_args(argv))["record"]
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
