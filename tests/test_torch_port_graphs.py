"""The executor's graph layer on the CPU: ``profile_dir``, the learner rule,
optimizer state across devices, the launch counters of every main-path
kernel wrapper (MultiATGCN's and SparseATGCN's), and parity with the JAX
executor.

On the CPU nothing is captured (CUDA graphs need the card; their tests are
in test_torch_port_graphs_cuda.py): the executor runs every step eagerly,
and these tests hold that path to the JAX executor per epoch, with and
without ``profile_dir``. The 12-node recipe of the verify notes at batch
16, 2 epochs of a short series, dropout off; torch on one intra-op thread.
"""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.graphs import launch_counters, read_launches
from multistgraph_tpu_torch.executor.optimizers import (
    CAPTURE_RULES,
    build_optimizer,
    capture_rule,
    load_optimizer_state,
    set_learning_rate,
)
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

TASK, MODEL, DATASET = "traffic_state_pred", "MultiATGCN", "SYN_GRAPHS"
EPOCHS = 2
PROFILE_EPOCH = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(raw, out):
    return {
        "data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out,
        "exp_id": "graphs", "cache_dataset": False, "max_epoch": EPOCHS, "train_rate": 0.7,
        "eval_rate": 0.15, "input_window": 24, "output_window": 6, "load_external": True,
        "load_dynamic": False, "add_time_in_day": True, "groupstd": True, "add_static": True,
        "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
        "interval_trend": 4, "rnn_units": 16, "embed_dim_node": 4, "embed_dim_adj": 4,
        "adjtype": "multi", "adpadj": "bidirection", "batch_size": 16, "seed": 0,
        "tensorboard": False,
    }


def _losses(metrics_log):
    with open(metrics_log) as f:
        rows = list(csv.DictReader(f))
    return [(r["train_loss"], r["val_loss"]) for r in rows]


def _train_port(root, name, init, **extra):
    args = dict(_args(os.path.join(root, "raw"), os.path.join(root, name)), **extra)
    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    train, val, _ = ds.get_data()
    model = get_model(cfg, ds.get_data_feature(), device="cpu")
    model.dropout_rate = 0.0
    model.load_state_dict(state_dict_from_jax(init, model))
    executor = get_executor(cfg, model, ds.get_data_feature(), device="cpu")
    executor.train(train, val)
    return executor


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX executor, and the port's trained from the same initial
    weights with and without ``profile_dir``."""
    root = str(tmp_path_factory.mktemp("port_graphs"))
    make_synthetic_dataset(os.path.join(root, "raw"), DATASET, num_nodes=12, len_time=24 * 12, seed=3)
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=_args(os.path.join(root, "raw"),
                                                                  os.path.join(root, "jax")))
    jds = jax_get_dataset(jcfg)
    jtrain, jval, _ = jds.get_data()
    jexec = jax_get_executor(jcfg, jax_get_model(jcfg, jds.get_data_feature()).clone(dropout_rate=0.0),
                             jds.get_data_feature())
    init = {k: np.asarray(v) for k, v in jexec.params["params"].items()}
    jexec.train(jtrain, jval)
    profile_dir = os.path.join(root, "trace")
    return {"jax": jexec, "plain": _train_port(root, "plain", init),
            "profiled": _train_port(root, "profiled", init, profile_dir=profile_dir,
                                    profile_epoch=PROFILE_EPOCH),
            "profile_dir": profile_dir}


def test_profile_dir_writes_one_trace_for_profile_epoch(runs):
    traces = sorted(os.listdir(runs["profile_dir"]))
    assert traces == ["epoch{}.pt.trace.json".format(PROFILE_EPOCH)]


def test_profile_trace_holds_the_step_ops_the_bptt_function_and_the_optimizer_step(runs):
    (path,) = glob.glob(os.path.join(runs["profile_dir"], "*.json"))
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"aten::einsum", "aten::index_select", "aten::sigmoid"} <= names
    assert any("_FusedATGRULayerBackward" in n for n in names)
    assert any(n.startswith("Optimizer.step#Adam.step") for n in names)


def test_losses_per_epoch_are_identical_with_and_without_profile_dir(runs):
    plain = _losses(runs["plain"]._metrics_log)
    assert len(plain) == EPOCHS
    assert _losses(runs["profiled"]._metrics_log) == plain


def test_eager_cpu_executor_matches_jax_per_epoch(runs):
    """The CPU executor captures nothing and still trains as JAX does, at
    test_torch_port_training.py's Adam bound (rtol 2e-5)."""
    got = np.array(_losses(runs["profiled"]._metrics_log), np.float64)
    want = np.array(_losses(runs["jax"]._metrics_log), np.float64)
    assert got.shape == want.shape == (EPOCHS, 2)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    executor = runs["profiled"]
    assert not executor.graphs_forward and not executor.graphs_train and executor.graphs == {}


@pytest.mark.parametrize("learner,rule", [
    ("adam", "device rate"), ("Adam", "device rate"), ("sparse_adam", "device rate"),
    ("rmsprop", "device rate"), ("sgd", "re-capture"), ("adagrad", "eager"),
    ("no_such_learner", "device rate"),  # an unknown learner is Adam
])
def test_capture_rule_by_learner_name(learner, rule):
    assert capture_rule(learner) == rule
    assert set(CAPTURE_RULES.values()) == {"device rate", "re-capture", "eager"}


@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop", "no_such_learner"])
def test_cpu_optimizers_keep_a_float_rate(learner):
    """CPU tensors refuse capturable=True: the CPU keeps the plain optimizers."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    opt = build_optimizer({"learner": learner, "learning_rate": 0.01}, params, device="cpu")
    group = opt.param_groups[0]
    assert group["lr"] == 0.01 and not group.get("capturable", False)
    set_learning_rate(opt, 0.5)
    assert group["lr"] == 0.5


def test_optimizer_state_loads_across_rate_forms():
    """A checkpoint whose rate is a device-style tensor and whose flags say
    capturable loads into a plain CPU optimizer as a float rate, flags kept;
    a float-rate checkpoint loads into an optimizer holding a tensor rate by
    filling that same tensor."""
    params = [torch.nn.Parameter(torch.ones(4))]
    plain = build_optimizer({"learning_rate": 0.01}, params, device="cpu")
    params[0].grad = torch.ones(4)
    plain.step()
    state = plain.state_dict()
    tensor_state = dict(state, param_groups=[dict(g, lr=torch.tensor(0.25), capturable=True, foreach=True)
                                             for g in state["param_groups"]])
    load_optimizer_state(plain, tensor_state)
    group = plain.param_groups[0]
    assert group["lr"] == 0.25 and isinstance(group["lr"], float)
    assert group["capturable"] is False
    assert torch.equal(plain.state[params[0]]["exp_avg"], state["state"][0]["exp_avg"])

    rate = torch.tensor(0.5)
    holder = torch.optim.Adam(params, lr=rate)
    load_optimizer_state(holder, dict(state, param_groups=[dict(g, lr=0.125) for g in state["param_groups"]]))
    assert holder.param_groups[0]["lr"] is rate and float(rate) == 0.125


def test_launch_counters_cover_the_main_path_wrappers():
    keys = set(launch_counters())
    assert {"node_apply.node_apply_q8.launches", "node_apply.node_apply_q8.launches_f32",
            "node_apply.node_apply_q8_t.launches", "node_apply.node_apply_q8_t.launches_f32",
            "layout.force_default_layout.launches", "layout.force_default_layout.backward_launches",
            "spmm.bsr_spmm.bf16_launches", "band.band_dv.f16_launches"} <= keys
    # SparseATGCN's path (its steps are graphs too): B4/B6 and B5 in f32, bf16
    # and f16; B7, B8 and B9 dX on planes and packed rows, f32/bf16 and f16
    sparse = {"spmm.{}.{}".format(fn, attr) for fn in ("bsr_spmm", "sampled_matmul")
              for attr in ("launches", "bf16_launches", "f16_launches")}
    sparse |= {"band.{}.{}".format(fn, attr) for fn in ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed")
               for attr in ("launches", "f16_launches")}
    assert sparse <= keys
    assert not any(".launches" not in k and "launches" not in k.split(".")[-1] for k in keys)
    assert not any(k.split(".")[1].startswith("_") for k in keys)
    assert set(read_launches()) == keys
