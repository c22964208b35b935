"""A/B timing of the single-seed MultiATGCN training step of two checkouts
on one GPU.

Runs this checkout and another one (e.g. the parent commit unpacked with
``git archive``) in turns, base, new, new, base, each visit in a process of
its own that imports that checkout's package. Each visit builds the
DC-237 flagship (237 nodes, hidden 64, K = 5, 2 layers, batch 16) from one
seeded draw and, in each of its four forms (int8: the int8 weight stream
at bf16 activations; int8 f32; bf16; f32), captures the executor's train
step (``train_epoch`` over 3 batches: 2 eager warm-up steps, then the
capture) and times 20 replays after 3, each ended by a synchronize (the
median on the host clock, as chip_smoke.py's graph phase takes it), then
profiles one replay by kernel (torch.profiler). With ``--bench`` each
visit also runs that checkout's ``bench.py --quant-stream`` and keeps its
epochs/hour. With ``--profile-runs K`` the first visit of each checkout
also runs K ``profile_dir`` trainings (2 epochs, epoch 1 traced) on the
first 4 and on the first 8 batches, in the int8 form, and counts the
trace's kernel records (a replayed step holds 192 B2/B2t, a replayed
validation batch 96 B2).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.ab_step --base <dir of the other checkout> [--bench] [--profile-runs K]
Prints one JSON line per visit, then one summary line: per form and
version the median over visits of the replay medians (and of the bench's
epochs/hour), new over base, and the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

N, H, T, B, NUM_LAYERS = 237, 64, 24, 16, 2
LEARNING_RATE = 3e-3
WARMUP_STEPS = 2          # the executor's eager steps before its capture
TIMED = 20
MODES = {"int8": {},
         "int8 f32": {"compute_dtype": "float32"},
         "bf16": {"weight_stream_quant": None},
         "f32": {"compute_dtype": None, "weight_stream_quant": None}}
PROFILE_BATCHES = (4, 8)


class _Rows:
    """The batches `rows` of a loader's split, in that order."""

    def __init__(self, loader, rows):
        self.x, self.y, self.batch_size = loader.x, loader.y, loader.batch_size
        self._perm = rows

    def __len__(self):
        return len(self._perm)

    def epoch_permutation(self):
        return self._perm

    ordered_permutation = epoch_permutation


def _args(work):
    """chip_smoke.py's DC-237 training arguments, rooted at `work`."""
    return {
        "data_dir": os.path.join(work, "raw_data"), "cache_dir": os.path.join(work, "dataset_cache"),
        "output_dir": os.path.join(work, "outputs"), "exp_id": "ab_step", "cache_dataset": False,
        "input_window": T, "output_window": T, "len_closeness": 2, "len_period": 1, "len_trend": 1,
        "interval_period": 7, "interval_trend": 28, "load_external": True, "load_dynamic": False,
        "add_time_in_day": True, "groupstd": True, "add_static": True, "adjtype": "multi",
        "adpadj": "bidirection", "rnn_units": H, "num_layers": NUM_LAYERS, "embed_dim_node": 20,
        "batch_size": B, "train_rate": 0.7, "eval_rate": 0.15, "seed": 0,
        "compute_dtype": "bfloat16", "weight_stream_quant": "int8",
        "saved_model": False, "tensorboard": False,
    }


def _by_kernel(torch, fn):
    """One call of `fn` under torch.profiler: the device ms, and every
    kernel's count and ms by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append(((us if us is not None else e.self_cuda_time_total) / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    return {"busy_ms": sum(r[0] for r in rows), "kernels": sum(r[1] for r in rows),
            "by_kernel": [{"name": k, "count": c, "ms": ms} for ms, c, k in rows]}


def worker(work, profile_runs):
    import torch

    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.executor import get_executor
    from multistgraph_tpu_torch.executor.optimizers import set_learning_rate
    from multistgraph_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def config(mode, **extra):
        return load_config("traffic_state_pred", "MultiATGCN", "SYN_DC237",
                           other_args=dict(_args(work), **MODES[mode], **extra))

    cfg = config("int8")
    dataset = get_dataset(cfg)
    train, val, _ = dataset.get_data()
    feature = dataset.get_data_feature()
    init = get_model(cfg, feature, device="cpu", generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in init.state_dict().items()}

    def executor(mode, **extra):
        cfg = config(mode, **extra)
        model = get_model(cfg, feature)
        model.load_state_dict(state)
        ex = get_executor(cfg, model, feature)
        set_learning_rate(ex.optimizer, LEARNING_RATE)
        return ex

    perm = train.epoch_permutation()
    record = {"modes": {}}
    for mode in MODES:
        ex = executor(mode)
        ex.train_epoch(_Rows(train, perm[: WARMUP_STEPS + 1]), LEARNING_RATE)
        graph = ex.graphs["train"]
        idx = torch.as_tensor(perm, device=ex.device)
        for i in range(3):
            graph.run(idx=idx[i])
        torch.cuda.synchronize()
        times = []
        for i in range(TIMED):
            t0 = time.perf_counter()
            graph.run(idx=idx[3 + i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = _by_kernel(torch, lambda: graph.run(idx=idx[0]))
        record["modes"][mode] = {"replay_ms": statistics.median(times), "replay_step_ms": times,
                                 "busy_ms": prof["busy_ms"], "kernels": prof["kernels"],
                                 "by_kernel": prof["by_kernel"][:25]}
        del ex, graph
        torch.cuda.empty_cache()
    if profile_runs:
        record["profile_dir"] = {}
        for batches in PROFILE_BATCHES:
            runs = []
            for _ in range(profile_runs):
                profile_dir = os.path.join(work, "profile")
                shutil.rmtree(profile_dir, ignore_errors=True)
                ex = executor("int8", profile_dir=profile_dir, max_epoch=2, load_best_epoch=False)
                ex.train(_Rows(train, perm[:batches]), _Rows(val, val.ordered_permutation()[:batches]))
                (trace,) = os.listdir(profile_dir)
                with open(os.path.join(profile_dir, trace)) as f:
                    events = json.load(f)["traceEvents"]
                kernels = [e for e in events if e.get("cat") == "kernel"]
                runs.append({"trace": trace, "events": len(events), "kernels": len(kernels),
                             "q8_kernels": sum(1 for e in kernels if "q8_kernel" in e.get("name", ""))})
                del ex
            record["profile_dir"][str(batches)] = {"want_q8": batches * 3 * 2 * T * NUM_LAYERS, "runs": runs}
    print(json.dumps(record), flush=True)


def _visit(root, work, profile_runs, bench):
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "--work-dir", work,
                          "--profile-runs", str(profile_runs)],
                         cwd=root, env=env, capture_output=True, text=True)
    if out.returncode:
        sys.stderr.write(out.stderr[-8000:])
        raise RuntimeError("the worker in {} failed ({})".format(root, out.returncode))
    record = json.loads(out.stdout.strip().splitlines()[-1])
    if bench:
        out = subprocess.run([sys.executable, "-m", "multistgraph_tpu_torch.bench", "--quant-stream",
                              "--work-dir", os.path.join(work, "bench")],
                             cwd=root, env=env, capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr[-8000:])
            raise RuntimeError("bench.py in {} failed ({})".format(root, out.returncode))
        line = json.loads(out.stdout.strip().splitlines()[-1])
        record["bench"] = {k: line[k] for k in ("value", "ms_per_step", "train_step", "final_loss")}
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of base, new, new, base")
    ap.add_argument("--bench", action="store_true", help="also run each checkout's bench.py --quant-stream")
    ap.add_argument("--profile-runs", type=int, default=0,
                    help="profile_dir runs at 4 and 8 batches in the first visit of each checkout")
    ap.add_argument("--work-dir", default=os.path.join("outputs", "ab_step"))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    cli = ap.parse_args(argv)
    if cli.worker:
        return worker(cli.work_dir, cli.profile_runs)

    from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
    from multistgraph_tpu_torch.tools.timing import card

    roots = {"base": os.path.abspath(cli.base), "new": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))}
    works = {}
    for name, root in roots.items():
        works[name] = os.path.join(os.path.abspath(cli.work_dir), name)
        shutil.rmtree(works[name], ignore_errors=True)
        make_synthetic_dataset(os.path.join(works[name], "raw_data"), "SYN_DC237", num_nodes=N,
                               len_time=24 * 151, node_mean=30.169, node_std=84.023, seed=42)
    visits = {"base": [], "new": []}
    for _ in range(cli.rounds):
        for name in ("base", "new", "new", "base"):
            first = not visits[name]
            record = _visit(roots[name], works[name], cli.profile_runs if first else 0, cli.bench)
            visits[name].append(record)
            print(json.dumps({"version": name, **record}), flush=True)
    summary = {"card": card(), "visits": {k: len(v) for k, v in visits.items()}, "modes": {}}
    for mode in MODES:
        row = {name: statistics.median(r["modes"][mode]["replay_ms"] for r in visits[name]) for name in visits}
        row["busy_ms"] = {name: statistics.median(r["modes"][mode]["busy_ms"] for r in visits[name])
                          for name in visits}
        row["new_over_base"] = row["new"] / row["base"]
        summary["modes"][mode] = row
    if cli.bench:
        row = {name: statistics.median(r["bench"]["value"] for r in visits[name]) for name in visits}
        row["new_over_base"] = row["new"] / row["base"]
        summary["bench_quant_stream_epochs_per_hour"] = row
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
