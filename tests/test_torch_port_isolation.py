"""The port runs without JAX, flax, pandas and the JAX package.

A fresh interpreter blocks the top-level modules ``jax``, ``jaxlib``,
``flax``, ``optax``, ``pandas`` and ``multistgraph_tpu`` (by exact name:
``multistgraph_tpu_torch`` starts with ``multistgraph_tpu`` and must stay
importable), imports every module of the port (the training slice's
executor, evaluator, losses, optimizers, pipeline, run_model and bench
among them), writes a small synthetic dataset with the port's generator,
serves one CPU predict through ``from_experiment``, then takes one int8
training step through ``get_executor`` and evaluates the test split, and
trains two seeds for one epoch as one widened step on a few of its batches
(``parallel.multiseed``) and serves one int8 weight-only quantized predict,
takes one SparseATGCN training step on the synthetic large-graph dataset,
in the plain BSR form and in the band form, and runs the node-apply
harness's numerics on the CPU at its documented reduced size
(``bench_node_dots --device cpu --small``), the band-stream probes'
(``probe_band_stream --small``) and one bf16 band step of the large-graph
bench (``bench_large_graph ... --dtype bf16 --device cpu``); trains a zoo
family (GRU, through the LSTM/GRU alias) for one epoch of a few batches
through ``run_model`` on the CPU and serves one predict of it, and runs
the zoo bench over all 18 names at its tiny size (``bench_zoo --device cpu
--small``); aggregates the MultiATGCN run's group-retransformed table
(``tools.aggregate_results``) and trains GRU's seeds 0 and 10 for one
epoch as one step, each seed then evaluated from its checkpoint
(``tools.multiseed_run --model GRU --device cpu``).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(r"""
    import importlib, importlib.abc, importlib.machinery, os, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "pandas", "multistgraph_tpu"}

    # Blocked modules look absent: find_spec gives a spec without an origin
    # (torch probes for optional modules, pandas among them, that way) and
    # importing one raises.
    class Block(importlib.abc.MetaPathFinder, importlib.abc.Loader):

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                return importlib.machinery.ModuleSpec(name, self)
            return None

        def create_module(self, spec):
            raise ImportError("blocked import of " + spec.name)

        def exec_module(self, module):
            raise ImportError("blocked import of " + module.__name__)

    sys.meta_path.insert(0, Block())

    import multistgraph_tpu_torch
    for info in pkgutil.walk_packages(multistgraph_tpu_torch.__path__, "multistgraph_tpu_torch."):
        importlib.import_module(info.name)
    for name in ("executor.executor", "executor.optimizers", "evaluator.evaluator", "ops.losses",
                 "utils.seeds", "utils.tbwriter", "pipeline", "run_model", "bench", "ops.bsr",
                 "ops.spmm", "ops.band", "ops.hybrid", "models.sparse_atgcn", "data.large_graph",
                 "ops.node_dots", "ops.stream_read", "tools.timing", "tools.bench_node_dots",
                 "tools.bench_hbm_peak", "tools.bench_stream_rate", "ops.band_probe", "ops.precision",
                 "tools.bench_large_graph", "tools.probe_band_stream", "parallel.multiseed", "ops.quantize",
                 "tools.multiseed_run", "run_model_parameter", "models.baselines", "models.graph_baselines",
                 "models.conv_baselines", "models.dcrnn", "models.astgcn", "models.zoo", "tools.bench_zoo",
                 "models.mtgnn", "models.stsgcn", "models.sttn", "models.gman", "models.stgode", "models.stgncde",
                 "graph.node2vec", "tools.aggregate_results", "tools.quality_run"):
        assert "multistgraph_tpu_torch." + name in sys.modules, name

    import numpy as np
    import torch
    from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
    from multistgraph_tpu_torch.serving import PredictService
    from multistgraph_tpu_torch.config import load_config
    from multistgraph_tpu_torch.data import get_dataset
    from multistgraph_tpu_torch.models import get_model

    work = sys.argv[1]
    make_synthetic_dataset(os.path.join(work, "raw"), "SYN", num_nodes=6, len_time=24 * 36, seed=1)
    args = {"data_dir": os.path.join(work, "raw"), "cache_dir": os.path.join(work, "cache"),
            "output_dir": os.path.join(work, "out"), "exp_id": "iso", "cache_dataset": False,
            "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
            "interval_trend": 4, "input_window": 24, "output_window": 6, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "groupstd": True,
            "compute_dtype": "bfloat16", "weight_stream_quant": "int8",
            "batch_size": 4, "rnn_units": 8, "embed_dim_node": 3, "embed_dim_adj": 3}
    cfg = load_config("traffic_state_pred", "MultiATGCN", "SYN", other_args=args)
    ds = get_dataset(cfg, device="cpu")
    _, _, test = ds.get_data()
    model = get_model(cfg, ds.get_data_feature(), device="cpu")
    cache = os.path.join(work, "out", "iso", "model_cache", "MultiATGCN_SYN.pt")
    os.makedirs(os.path.dirname(cache))
    torch.save((model.state_dict(), {}), cache)
    service = PredictService.from_experiment("traffic_state_pred", "MultiATGCN", "SYN",
                                             other_args=args, device="cpu")
    y = service.predict(test.x[:3].numpy())
    assert y.shape == (3, 6, 6, 1) and np.isfinite(y).all(), y.shape

    from multistgraph_tpu_torch.executor import get_executor
    train, _, _ = ds.get_data()
    executor = get_executor(cfg, model, ds.get_data_feature(), device="cpu")
    loss = executor.train_step(executor.batch(train, train.epoch_permutation()[0]))
    assert torch.isfinite(loss), loss
    result = executor.evaluate(test)
    assert np.isfinite(result["masked_MAE"]).all(), result

    from multistgraph_tpu_torch.data.loader import DeviceDataLoader
    from multistgraph_tpu_torch.parallel.multiseed import train_multiseed
    mcfg = load_config("traffic_state_pred", "MultiATGCN", "SYN",
                       other_args=dict(args, exp_id="iso_ms", max_epoch=1, tensorboard=False))
    mexec = get_executor(mcfg, get_model(mcfg, ds.get_data_feature(), device="cpu"), ds.get_data_feature(),
                         device="cpu")
    short = DeviceDataLoader(train.x[:8].numpy(), train.y[:8].numpy(), 4, True)
    results = train_multiseed(mexec, short, DeviceDataLoader(test.x[:4].numpy(), test.y[:4].numpy(), 4, False),
                              [0, 10], save=True)
    assert [r.seed for r in results] == [0, 10] and all(os.path.exists(r.checkpoint) for r in results)
    assert all(np.isfinite(r.history[0]["train_loss"]) for r in results), results
    qservice = PredictService.from_experiment("traffic_state_pred", "MultiATGCN", "SYN", other_args=args,
                                              device="cpu", quantize="int8")
    assert np.isfinite(qservice.predict(test.x[:2].numpy())).all() and qservice.stats()["quantize"] == "int8"

    sargs = {"output_dir": os.path.join(work, "out"), "exp_id": "iso_sparse", "num_nodes": 200,
             "avg_degree": 8, "len_time": 40, "input_window": 4, "output_window": 2, "batch_size": 2,
             "rnn_units": 4, "embed_dim_adj": 3, "tensorboard": False}
    for split in ("none", "band"):
        scfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE",
                           other_args=dict(sargs, graph_split=split))
        sds = get_dataset(scfg, device="cpu")
        strain, _, _ = sds.get_data()
        smodel = get_model(scfg, sds.get_data_feature(), device="cpu")
        assert hasattr(smodel, "support0_band_values") == (split == "band")
        sexec = get_executor(scfg, smodel, sds.get_data_feature(), device="cpu")
        loss = sexec.train_step(sexec.batch(strain, strain.epoch_permutation()[0]))
        assert torch.isfinite(loss), loss
    from multistgraph_tpu_torch.tools import bench_node_dots
    assert bench_node_dots.main(["--device", "cpu", "--small"]) is None
    from multistgraph_tpu_torch.tools import bench_large_graph, probe_band_stream
    assert probe_band_stream.main(["--small"])["ok"]
    record = bench_large_graph.main(["512", "8", "2", "1", "band", "--dtype", "bf16", "--adpadj", "none",
                                     "--hidden", "4", "--iters", "1", "--device", "cpu"])
    assert np.isfinite(record["extras"]["losses"]).all(), record

    from multistgraph_tpu_torch.pipeline import run_model
    zargs = {"data_dir": os.path.join(work, "raw"), "cache_dir": os.path.join(work, "cache"),
             "output_dir": os.path.join(work, "out"), "exp_id": "iso_zoo", "cache_dataset": False,
             "input_window": 12, "output_window": 3, "load_external": True, "load_dynamic": False,
             "add_time_in_day": True, "rnn_units": 4, "batch_size": 4, "max_epoch": 1,
             "train_rate": 0.03, "eval_rate": 0.02, "tensorboard": False}
    zresult = run_model("traffic_state_pred", "GRU", "SYN", other_args=zargs, device="cpu")
    assert np.isfinite(zresult["masked_MAE"]).all(), zresult
    zservice = PredictService.from_experiment("traffic_state_pred", "GRU", "SYN", other_args=zargs, device="cpu")
    assert type(zservice.model).__name__ == "RNNModel" and zservice.model.kind == "GRU"
    zy = zservice.predict(np.zeros((2, 12, 6, 2), np.float32))
    assert zy.shape == (2, 3, 6, 1) and np.isfinite(zy).all(), zy.shape
    from multistgraph_tpu_torch.tools import bench_zoo
    zoo = bench_zoo.main(["--device", "cpu", "--small"])
    assert len(zoo["extras"]["models"]) == 18 and np.isfinite(zoo["value"]), zoo
    from multistgraph_tpu_torch.tools import aggregate_results, multiseed_run
    summary = aggregate_results.main([os.path.join(work, "out"), "--horizons", "3", "6", "--reference", "MultiATGCN",
                                      "--out", os.path.join(work, "summary.csv")])
    assert list(summary["Model_name"]) == ["MultiATGCN"] * 2 and list(summary["MAE_vs_ref_pct"]) == [0.0, 0.0]
    import json
    with open(os.path.join(work, "config_ms.json"), "w") as f:
        json.dump({"max_epoch": 1, "input_window": 12, "output_window": 3, "rnn_units": 4, "batch_size": 4,
                   "train_rate": 0.03, "eval_rate": 0.02, "tensorboard": False, "cache_dataset": False}, f)
    seeds = multiseed_run.main(["--model", "GRU", "--dataset", "SYN", "--config_file", "config_ms",
                                "--seeds", "0", "10", "--exp_id", "iso_ms_zoo", "--device", "cpu",
                                "--data_dir", os.path.join(work, "raw"), "--output_dir", os.path.join(work, "out")])
    assert [r.seed for r in seeds] == [0, 10] and all(os.path.exists(r.checkpoint) for r in seeds)
    assert all(np.isfinite(r.history[0]["train_loss"]) for r in seeds), seeds
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("ISOLATED_OK")
""")


def test_port_imports_and_serves_without_jax_pandas_or_the_jax_package(tmp_path):
    # one intra-op thread, as the port's other CPU tests use beside other workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED_OK" in proc.stdout
