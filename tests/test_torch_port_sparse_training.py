"""The port's SparseATGCN path end to end on the CPU, against the JAX package.

The synthetic large-graph dataset at 200 nodes (two 128-node blocks), the
JAX executor (Pallas kernels in interpret mode) and the port's, trained 2
epochs with SGD from the same initial weights through the same shuffles,
then evaluated and served. SparseATGCN has no dropout, so nothing random
differs. Tolerances: per-epoch train and validation loss rtol 1e-5, the
evaluation metrics rtol 1e-4, served outputs rtol 1e-5 with atol 1e-4
(f32 on both sides, sums in other orders; MultiATGCN's SGD parity,
tests/test_torch_port_training.py, reads 7 equal digits).
A training step on the card, with its launch counts, is in
tests/test_torch_port_sparse_cuda.py.
"""

import csv
import glob
import os

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch import run_model as run_model_cli
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import SparseATGCN, get_model
from multistgraph_tpu_torch.serving import PredictService

TASK, MODEL, DATASET = "traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY"
EPOCHS = 2


def _args(out, **extra):
    """A tiny SYN_LARGE: 200 nodes, one layer of the model's defaults at hidden 8."""
    return dict({
        "output_dir": out, "exp_id": "sparse", "num_nodes": 200, "avg_degree": 8, "len_time": 48,
        "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8, "embed_dim_adj": 4,
        "num_layers": 1, "max_epoch": EPOCHS, "learner": "sgd", "learning_rate": 0.01, "seed": 0,
        "tensorboard": False,
    }, **extra)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metrics_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]), np.array([float(r["val_loss"]) for r in rows]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from multistgraph_tpu.config import load_config as jax_load_config
    from multistgraph_tpu.data import get_dataset as jax_get_dataset
    from multistgraph_tpu.executor import get_executor as jax_get_executor
    from multistgraph_tpu.models import get_model as jax_get_model
    from multistgraph_tpu.serving import PredictService as JaxPredictService
    from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

    root = str(tmp_path_factory.mktemp("port_sparse"))
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=_args(os.path.join(root, "jax"), pallas_interpret=True))
    jds = jax_get_dataset(jcfg)
    jtrain, jval, jtest = jds.get_data()
    jfeature = jds.get_data_feature()
    jexec = jax_get_executor(jcfg, jax_get_model(jcfg, jfeature), jfeature)
    init = {k: np.asarray(v) for k, v in jexec.params["params"].items()}
    jexec.train(jtrain, jval)
    jresult = jexec.evaluate(jtest)
    x = np.asarray(jtest.x)[:3]
    jserved = JaxPredictService(jexec.model, jexec.params, jfeature["scaler"], max_batch=4).predict(x)

    args = _args(os.path.join(root, "port"))
    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    train, val, test = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature, device="cpu")
    model.load_state_dict(state_dict_from_jax(init, model))
    executor = get_executor(cfg, model, feature, device="cpu")
    executor.train(train, val)
    result = executor.evaluate(test)
    return dict(jexec=jexec, jresult=jresult, jserved=jserved, x=x, executor=executor, result=result,
                test=test, feature=feature, args=args, cfg=cfg)


def test_dataset_and_first_batches_match_jax(trained):
    from multistgraph_tpu.config import load_config as jax_load_config
    from multistgraph_tpu.data import get_dataset as jax_get_dataset

    args = _args("unused")
    jds = jax_get_dataset(jax_load_config(TASK, MODEL, DATASET, other_args=args))
    jloaders = jds.get_data()
    ds = get_dataset(load_config(TASK, MODEL, DATASET, other_args=args), device="cpu")
    loaders = ds.get_data()
    jg, g = jds.get_data_feature()["bsr_graph"], ds.get_data_feature()["bsr_graph"]
    for name in ("values", "row_of", "col_of"):
        np.testing.assert_array_equal(getattr(g, name), getattr(jg, name))
    assert ds.get_data_feature()["num_nodes"] == 256
    for jl, pl in zip(jloaders, loaders):
        assert len(jl) == len(pl)
        np.testing.assert_array_equal(pl.epoch_permutation(), jl.epoch_permutation())
        np.testing.assert_array_equal(pl.x[:8].numpy(), np.asarray(jl.x)[:8])
        np.testing.assert_array_equal(pl.y[:8].numpy(), np.asarray(jl.y)[:8])


def test_executor_losses_per_epoch_match_jax(trained):
    got_train, got_val = _metrics_csv(trained["executor"]._metrics_log)
    want_train, want_val = _metrics_csv(trained["jexec"]._metrics_log)
    assert len(got_train) == len(want_train) == EPOCHS
    np.testing.assert_allclose(got_train, want_train, rtol=1e-5)
    np.testing.assert_allclose(got_val, want_val, rtol=1e-5)


def test_executor_evaluation_matches_jax(trained):
    result, jresult = trained["result"], trained["jresult"]
    assert list(result) == list(jresult.columns)
    for metric in result:
        np.testing.assert_allclose(result[metric], jresult[metric].to_numpy(), rtol=1e-4, err_msg=metric)


def test_saved_model_serves_what_jax_serves(trained):
    executor, args = trained["executor"], trained["args"]
    cache = os.path.join(args["output_dir"], "sparse", "model_cache", "{}_{}.pt".format(MODEL, DATASET))
    executor.save_model(cache)
    service = PredictService.from_experiment(TASK, MODEL, DATASET, other_args=args, max_batch=4, device="cpu")
    assert isinstance(service.model, SparseATGCN)
    got = service.predict(trained["x"])
    assert got.shape == (3, 2, 256, 1)
    np.testing.assert_allclose(got, trained["jserved"], rtol=1e-5, atol=1e-4)


def test_checkpoint_reload_gives_identical_predictions(trained):
    executor, test = trained["executor"], trained["test"]
    before = executor.predict(test)
    (path,) = glob.glob(os.path.join(executor.cache_dir, "*_epoch*.pt"))[-1:]
    blob = torch.load(path, weights_only=True)
    assert not any(k.startswith(("support", "adaptive")) for k in blob["model"])  # the graph is rebuilt
    fresh = get_executor(trained["cfg"], get_model(trained["cfg"], trained["feature"], device="cpu"),
                         trained["feature"], device="cpu")
    fresh.load_model_with_epoch(blob["epoch"])
    np.testing.assert_array_equal(fresh.predict(test), before)


def test_run_model_cli_trains_and_reuses_sparse_atgcn(tmp_path):
    argv = ["--model", MODEL, "--dataset", DATASET, "--exp_id", "cli", "--output_dir", str(tmp_path / "out"),
            "--num_nodes", "200", "--avg_degree", "8", "--len_time", "48", "--input_window", "4",
            "--output_window", "2", "--rnn_units", "4", "--embed_dim_adj", "3", "--num_layers", "1",
            "--batch_size", "4", "--graph_split", "none", "--remat", "false", "--config_file", "cfg"]
    (tmp_path / "cfg.json").write_text('{"max_epoch": 1, "tensorboard": false}')
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        (trained,) = run_model_cli.main(argv + ["--device", "cpu"])
        # gpu false in the config means the CPU, as --device cpu does
        (reused,) = run_model_cli.main(argv + ["--train", "false", "--gpu", "false"])
    finally:
        os.chdir(cwd)
    out = tmp_path / "out" / "cli"
    assert (out / "model_cache" / "{}_{}.pt".format(MODEL, DATASET)).exists()
    assert glob.glob(str(out / "evaluate_cache" / "*_predictions.npz"))
    for metric, values in trained.items():
        assert metric == "MAPE" or np.isfinite(values).all(), metric
        np.testing.assert_array_equal(reused[metric], values)


def test_entry_points_raise_without_cuda(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_dataset(trained["cfg"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(trained["cfg"], trained["feature"])
