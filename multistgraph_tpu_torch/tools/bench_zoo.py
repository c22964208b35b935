"""The model zoo's train step: one loss + grad + Adam step of each ported family.

Counterpart of tools/bench_zoo.py for the names the port has
(config/defaults.ZOO_MODELS). Each name is built from the registry with
its shipped defaults at DC-237 scale (B=16, Tin=24, Tout=24, N=237, F=2,
a random 5%-dense graph from seed 0), and its eager step (the loss
mean |pred - y|, backward, Adam at 1e-3) is timed on the card by
``timing.slope_time`` (trips 2, 4, 8), which cancels the fixed cost of a
timed run. One line per name on stderr, then one JSON line with the card's
name and power limit. A name of the zoo not ported yet raises.

On the CPU (``--device cpu``) each name takes one step after a warm-up
one, timed on the host clock (no device metric); ``--small`` runs tiny shapes (B=2, Tin=12,
Tout=3, N=8). Without a card and without ``--device cpu`` it raises.

Usage:
    python -m multistgraph_tpu_torch.tools.bench_zoo [name ...]
    python -m multistgraph_tpu_torch.tools.bench_zoo --device cpu --small
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from multistgraph_tpu_torch.config.defaults import MODEL_DEFAULTS, ZOO_MODELS
from multistgraph_tpu_torch.models.registry import MODEL_REGISTRY
from multistgraph_tpu_torch.tools.timing import card, slope_time
from multistgraph_tpu_torch.utils.device import resolve_device

# the JAX package's zoo, in its bench's order
ZOO = ("RNN", "LSTM", "GRU", "FNN", "Seq2Seq", "TGCN", "AGCRN", "STGCN", "GWNET", "DCRNN", "ASTGCN", "MSTGCN",
       "MTGNN", "STSGCN", "STTN", "GMAN", "STGODE", "STGNCDE")
FULL = dict(batch=16, tin=24, tout=24, nodes=237)
SMALL = dict(batch=2, tin=12, tout=3, nodes=8)
FEATURES = 2


def build(name, shape, device, rng):
    """(model, x, y) of `name` at `shape`, its weights from seed 0."""
    if name not in ZOO_MODELS:
        raise NotImplementedError("{} is not ported yet (ROADMAP.md A.5)".format(name))
    builder = "RNN" if name in ("LSTM", "GRU") else name
    config = dict(MODEL_DEFAULTS["traffic_state_pred/{}".format(builder)])
    config.update(output_window=shape["tout"], input_window=shape["tin"], add_time_in_day=True,
                  time_intervals=3600, seed=0)
    if name in ("LSTM", "GRU"):
        config["rnn_type"] = name
    n = shape["nodes"]
    adj = (rng.random((n, n)) < 0.05).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    feature = {"num_nodes": n, "feature_dim": FEATURES, "output_dim": 1, "adj_mx": adj}
    model = MODEL_REGISTRY[builder](config, feature, device=device)
    x = torch.as_tensor(rng.normal(size=(shape["batch"], shape["tin"], n, FEATURES)).astype(np.float32),
                        device=device)
    y = torch.as_tensor(rng.normal(size=(shape["batch"], shape["tout"], n, 1)).astype(np.float32), device=device)
    return model, x, y


def bench_model(name, shape, device, rng):
    """{"step_ms", "params", "loss"} of one name: the slope of the card's
    eager steps, or on the CPU one step's host milliseconds after a warm-up."""
    model, x, y = build(name, shape, device, rng)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = (model(x) - y).abs().mean()
        loss.backward()
        opt.step()
        return loss.detach()

    if device.type == "cuda":
        per_step, totals = slope_time(lambda k: lambda: [step() for _ in range(k)], trips=(2, 4, 8))
        step_ms, extra = per_step * 1e3, {"totals_s": totals}
    else:
        step()   # the first step's one-time costs
        t0 = time.perf_counter()
        step()
        step_ms, extra = (time.perf_counter() - t0) * 1e3, {"host_clock": True}
    loss = float(step())
    if not np.isfinite(loss):
        raise AssertionError("{}: the loss is {}".format(name, loss))
    return dict(step_ms=step_ms, params=sum(p.numel() for p in model.parameters()), loss=loss, **extra)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("names", nargs="*", default=list(ZOO_MODELS))
    parser.add_argument("--device", default=None, help="'cpu' for the CPU; the card otherwise")
    parser.add_argument("--small", action="store_true", help="tiny shapes (B=2, Tin=12, Tout=3, N=8)")
    args = parser.parse_args(argv)
    unknown = [n for n in args.names if n not in ZOO]
    if unknown:
        raise ValueError("not in the zoo: {}".format(unknown))
    device = resolve_device(args.device)
    shape = SMALL if args.small else FULL
    rng = np.random.default_rng(0)
    results = {}
    for name in args.names:
        results[name] = bench_model(name, shape, device, rng)
        print("{:>8}: {:8.2f} ms/step  ({:.2f}M params)".format(
            name, results[name]["step_ms"], results[name]["params"] / 1e6), file=sys.stderr)
    record = {
        "metric": "model_zoo_step_ms_median",
        "value": statistics.median(r["step_ms"] for r in results.values()),
        "unit": "ms/step",
        "extras": {"models": results, **shape, "features": FEATURES, "device": device.type,
                   "card": card() if device.type == "cuda" else None},
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
