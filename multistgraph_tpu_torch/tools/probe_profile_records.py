"""Where ``profile_dir``'s traces lose kernel records, on one GPU.

Runs the executor's ``profile_dir`` training of the int8 DC-237 flagship
(237 nodes, hidden 64, K = 5, 2 layers, batch 16) on the first
``--batches`` training and validation batches, 2 epochs with epoch 1
traced (every train step and validation batch of it a CUDA graph replay:
192 B2/B2t and 96 B2 kernels), ``--runs`` times at each of the
``--margins-ms`` (the executor's ``PROFILE_MARGIN_S``, the host's sleep
after the profiler starts and before it stops; 0 traces as the executor
did before it had one). For each run it reads the trace and reports the
kernel records by graph launch (the ``correlation`` of the launch each
kernel record carries, in the order of the launches), the span of the
kernel records against the span of the host's events, and the B2/B2t
records against the 288 a batch the epoch launches.

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.probe_profile_records [--runs 6] [--batches 8] [--margins-ms 0 20]
Prints one JSON line per run and a summary line with the card's name and
power limit.
"""

import argparse
import collections
import json
import os
import shutil

from multistgraph_tpu_torch.tools.ab_step import NUM_LAYERS, T, _args, _Rows

LEARNING_RATE = 3e-3


def _read(path, batches):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation") and "dur" in e]
    by_launch = collections.defaultdict(list)
    for e in kernels:
        by_launch[e.get("args", {}).get("correlation")].append(e)
    order = sorted(by_launch, key=lambda c: min(e["ts"] for e in by_launch[c]))
    return {
        "kernels": len(kernels),
        "q8_kernels": sum(1 for e in kernels if "q8_kernel" in e.get("name", "")),
        "want_q8": batches * 3 * 2 * T * NUM_LAYERS,
        "kernels_by_launch": [len(by_launch[c]) for c in order],
        "q8_by_launch": [sum(1 for e in by_launch[c] if "q8_kernel" in e.get("name", "")) for c in order],
        "kernel_span_us": [min(e["ts"] for e in kernels), max(e["ts"] + e["dur"] for e in kernels)],
        "host_span_us": [min(e["ts"] for e in host), max(e["ts"] + e["dur"] for e in host)],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--margins-ms", type=float, nargs="+", default=[0.0, 20.0])
    ap.add_argument("--work-dir", default=os.path.join("outputs", "probe_profile_records"))
    cli = ap.parse_args(argv)

    import torch

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
    from multistgraph_tpu_torch.executor import executor as executor_module
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.executor.optimizers import set_learning_rate
    from multistgraph_tpu_torch.models import get_model
    from multistgraph_tpu_torch.tools.timing import card

    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.abspath(cli.work_dir)
    shutil.rmtree(work, ignore_errors=True)
    make_synthetic_dataset(os.path.join(work, "raw_data"), "SYN_DC237", num_nodes=237, len_time=24 * 151,
                           node_mean=30.169, node_std=84.023, seed=42)
    profile_dir = os.path.join(work, "profile")
    args = dict(_args(work), profile_dir=profile_dir, max_epoch=2, load_best_epoch=False)
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN_DC237", other_args=args)
    dataset = get_dataset(cfg)
    train, val, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    state = get_model(cfg, feature, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    train_rows = _Rows(train, train.epoch_permutation()[: cli.batches])
    val_rows = _Rows(val, val.ordered_permutation()[: cli.batches])
    summary = {"card": card(), "batches": cli.batches}
    for margin_ms in cli.margins_ms:
        executor_module.PROFILE_MARGIN_S = margin_ms / 1e3
        lost = []
        for run in range(cli.runs):
            shutil.rmtree(profile_dir, ignore_errors=True)
            model = get_model(cfg, feature)
            model.load_state_dict(state)
            ex = get_executor(cfg, model, feature)
            set_learning_rate(ex.optimizer, LEARNING_RATE)
            ex.train(train_rows, val_rows)
            (trace,) = os.listdir(profile_dir)
            record = _read(os.path.join(profile_dir, trace), cli.batches)
            lost.append(record["want_q8"] - record["q8_kernels"])
            print(json.dumps({"margin_ms": margin_ms, "run": run, "trace": trace, **record}), flush=True)
            del ex, model
        summary["margin {} ms".format(margin_ms)] = {"q8_records_lost_by_run": lost}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
