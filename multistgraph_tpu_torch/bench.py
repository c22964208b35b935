"""Training throughput of MultiATGCN on the DC-237 flagship workload, on one GPU.

The port's twin of the repository's bench.py: the same synthetic DC-237
dataset (237 nodes, hourly, closeness 2 / period 1 / trend 1 at 7/28-day
strides, 24-step horizon, multi-view supports with the bidirectional
adaptive view, static features, batch 16, bf16 matmuls) and the same
arguments, trained by the port's executor: one warm-up epoch, then
TIMED_EPOCHS (``--timed-epochs``) timed epochs at a fixed rate of 3e-3. ``--quant-stream``
streams the h-side weights int8 through kernels B2 and B2t. The epochs
are the executor's ``train_epoch``: after its first two eager steps, each
step is a replay of the captured CUDA graph of the train step
(executor/graphs.py), the counterpart of JAX's compiled epoch.

``--multiseed S`` then times the protocol's real workload, S seeds (0, 10,
100, 1000, then fillers, as bench.py:211-215 chooses them) trained as one
widened step (parallel/multiseed.py), and reports the aggregate
seed-epochs/hr against S sequential runs of the single-seed epoch just
measured (counterpart of bench.py:16-19,202-263).

Run:  python -m multistgraph_tpu_torch.bench [--quant-stream] [--multiseed S]

Prints one JSON line: epochs/hr and ms/step on the card, how the step ran
(``train_step``: "cuda graph" or "eager"), the dtype and weight stream, and
the card's name and power limit (nvidia-smi); with ``--multiseed`` the
aggregate rate is ``value``, beside the single-seed rate and the ratio.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.parallel.multiseed import MultiSeedTrainer, protocol_seeds
from multistgraph_tpu_torch.tools.timing import card
from multistgraph_tpu_torch.utils import resolve_device

NUM_NODES = 237
LEN_TIME = 24 * 151  # Jan 1 - May 31 hourly, like DC
TIMED_EPOCHS = 3
LEARNING_RATE = 3e-3


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_args(work_dir: str) -> dict:
    """bench.py's DC-237 arguments (bench.py:92-111), rooted at `work_dir`."""
    return {
        "data_dir": os.path.join(work_dir, "raw_data"),
        "cache_dir": os.path.join(work_dir, "dataset_cache"),
        "output_dir": os.path.join(work_dir, "outputs"),
        # the bench builds its windows each run: on an H100 machine the data
        # were ready in 10.1 s so, 43.4 s when their 0.6 GB cache was written
        "exp_id": "bench", "cache_dataset": False,
        "input_window": 24, "output_window": 24,
        "len_closeness": 2, "len_period": 1, "len_trend": 1,
        "interval_period": 7, "interval_trend": 28,
        "load_external": True, "load_dynamic": False, "add_time_in_day": True,
        "groupstd": True, "add_static": True,
        "adjtype": "multi", "adpadj": "bidirection",
        "batch_size": 16, "train_rate": 0.7, "eval_rate": 0.15,
        "max_epoch": TIMED_EPOCHS, "saved_model": False, "use_early_stop": False,
        "seed": 0, "compute_dtype": "bfloat16", "tensorboard": False,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant-stream", action="store_true",
                    help="stream the h-side node-conditioned weights int8 through kernels B2/B2t")
    ap.add_argument("--multiseed", type=int, default=0,
                    help="time S protocol seeds trained as one widened step and report the "
                         "aggregate epochs/hr (0 = the single-seed run only)")
    ap.add_argument("--timed-epochs", type=int, default=TIMED_EPOCHS,
                    help="timed epochs of each run, after its warm-up epoch")
    ap.add_argument("--work-dir", default=os.path.join("outputs", "bench_torch"),
                    help="where the synthetic dataset and run outputs go")
    cli = ap.parse_args(argv)
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    args = bench_args(cli.work_dir)
    ds_name = "SYN_DC237"
    if not os.path.exists(os.path.join(args["data_dir"], ds_name, "config.json")):
        log("generating synthetic DC-237 dataset ...")
        make_synthetic_dataset(args["data_dir"], ds_name, num_nodes=NUM_NODES, len_time=LEN_TIME,
                               node_mean=30.169, node_std=84.023, seed=42)
    if cli.quant_stream:
        args["weight_stream_quant"] = "int8"
    config = load_config("traffic_state_pred", "MultiATGCN", ds_name, other_args=args)
    t0 = time.time()
    dataset = get_dataset(config, device)
    train_loader, _, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    log("data ready in {:.1f}s ({} train batches)".format(time.time() - t0, len(train_loader)))
    executor = get_executor(config, get_model(config, feature, device=device), feature, device=device)

    def run_epoch():
        loss = executor.train_epoch(train_loader, LEARNING_RATE)  # reads the loss: a host sync
        torch.cuda.synchronize()
        return loss

    t0 = time.time()
    loss = run_epoch()
    log("warm-up epoch {:.1f}s, loss {:.4f}".format(time.time() - t0, loss))
    t0 = time.time()
    for _ in range(cli.timed_epochs):
        loss = run_epoch()
    epoch_seconds = (time.time() - t0) / cli.timed_epochs
    step_ms = 1e3 * epoch_seconds / len(train_loader)
    log("epoch {:.3f}s | {:.2f} ms/step | final loss {:.4f} | {}".format(
        epoch_seconds, step_ms, loss, torch.cuda.get_device_name(0)))
    record = {
        "metric": "epochs_per_hour_dc237",
        "value": 3600.0 / epoch_seconds,
        "unit": "epochs/hr",
        "ms_per_step": step_ms,
        "train_batches": len(train_loader),
        "train_step": "cuda graph" if executor.graphs_train else "eager",
        "final_loss": loss,
        "dtype": config.get("compute_dtype", "float32"),
        "weight_stream": "int8" if cli.quant_stream else config.get("compute_dtype", "float32"),
        "card": card(),
    }
    if cli.multiseed > 1:
        record.update(bench_multiseed(cli.multiseed, executor, train_loader, epoch_seconds, cli.timed_epochs))
    print(json.dumps(record), flush=True)
    return record


def bench_multiseed(count: int, executor, train_loader, single_epoch_seconds: float,
                    timed_epochs: int = TIMED_EPOCHS) -> dict:
    """`count` protocol seeds trained as one widened step: one warm-up and
    `timed_epochs` timed epochs at LEARNING_RATE, each seed through its own
    shuffle stream. Returns the record's multi-seed fields: the aggregate
    seed-epochs/hr as ``value``, and its ratio over `count` sequential runs
    of the single-seed epoch (`single_epoch_seconds`)."""
    seeds = protocol_seeds(count)
    trainer = MultiSeedTrainer(executor, seeds)
    rngs = [np.random.default_rng(s) for s in seeds]
    num_batches, batch_size = len(train_loader), train_loader.batch_size

    def run_epoch():
        perms = []
        for rng in rngs:
            order = np.arange(train_loader.num_samples)
            rng.shuffle(order)
            perms.append(order[: num_batches * batch_size].reshape(num_batches, batch_size))
        losses = trainer.train_epoch(train_loader, perms, [LEARNING_RATE] * count)  # a host sync
        torch.cuda.synchronize()
        return losses

    t0 = time.time()
    losses = run_epoch()
    log("multi-seed warm-up epoch {:.1f}s, losses {}".format(time.time() - t0, np.round(losses, 4)))
    t0 = time.time()
    for _ in range(timed_epochs):
        losses = run_epoch()
    epoch_seconds = (time.time() - t0) / timed_epochs
    aggregate = count * 3600.0 / epoch_seconds
    ratio = count * single_epoch_seconds / epoch_seconds
    log("multi-seed x{}: {:.3f}s an epoch of all seeds -> {:.1f} aggregate epochs/hr, {:.2f}x over {} "
        "sequential runs".format(count, epoch_seconds, aggregate, ratio, count))
    return {
        "metric": "aggregate_epochs_per_hour_dc237_x{}seeds".format(count),
        "value": aggregate,
        "ms_per_step": 1e3 * epoch_seconds / num_batches,
        "final_loss": float(np.mean(losses)),
        "final_losses": [float(v) for v in losses],
        "train_step": "cuda graph" if trainer.graphs_train else "eager",
        "seeds": seeds,
        "single_seed_epochs_per_hour": 3600.0 / single_epoch_seconds,
        "single_seed_ms_per_step": 1e3 * single_epoch_seconds / num_batches,
        "ratio_over_sequential": ratio,
    }


if __name__ == "__main__":
    main()
