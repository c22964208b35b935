"""The port's training stack against the JAX package: losses, evaluator
metrics, optimizers and schedulers, and the executor end to end.

Tolerances, each with its reason:
  * losses and metrics: rtol 1e-6 (the same f32 formulas; reductions may
    sum in another order);
  * optimizers: rtol 2e-5 on the parameters after 5 steps. torch.optim
    and optax apply the same update rules, but optax computes Adam's bias
    corrections 1 - b^t in f32 where torch takes Python floats: f32(0.999)
    puts 1.3e-5 of relative error into 1 - b2, so the first steps differ by
    ~6e-6 relative (the readings: 6.4e-6 for Adam, 3.5e-6 for RMSprop with
    momentum and clipping, below 1e-6 for the rest);
  * the executor, 2 epochs in f32 without dropout from the same initial
    weights through the same shuffles, on a 12-day series (15 training
    batches per epoch), with SGD: per-epoch train and validation loss
    rtol 1e-5, evaluation metrics and the per-horizon group de-z-scored
    rows rtol 1e-4 (the readings agree to 7 digits in the losses, 1.6e-5
    in the metrics). With Adam, the model's default: losses rtol 2e-5,
    metrics and rows rtol 1e-3. Adam takes a step of about the learning
    rate for every parameter whatever the size of its gradient, so a
    last-bit difference in a near-zero gradient can flip a step. The
    readings at this seed are 1.1e-6 in the losses and 5.1e-5 in the
    metrics and rows; over four other (data, model) seeds (0, 1), (1, 2),
    (2, 3) at most 3.2e-6 and 1.7e-4, so the limits are about 6x the
    largest. A flip can carry it much further: seeds (5, 7) read 4.8e-5
    and 0.37 (a metric near zero), and a 35-day series (64 batches per
    epoch) read 4.2e-4 and 3.8e-3.
A training step on the card is tests/test_torch_port_training_cuda.py,
which imports no JAX.
"""

import csv
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.evaluator.evaluator import TrafficStateEvaluator as JaxEvaluator
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.executor.optimizers import LRScheduler as JaxLRScheduler
from multistgraph_tpu.executor.optimizers import build_optimizer as jax_build_optimizer
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu.ops import losses as jax_losses
from multistgraph_tpu_torch import run_model as run_model_cli
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.evaluator import TrafficStateEvaluator, evaluate_model
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.optimizers import (
    LRScheduler,
    build_lr_scheduler,
    build_optimizer,
    clip_by_global_norm,
)
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.ops import losses
from multistgraph_tpu_torch.serving import PredictService
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run thousands of tiny CPU ops, and
    beside other test workers on the same cores an OpenMP team per op
    spends far more time waiting than working."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ losses

_LOSS_CALLS = {
    # the executor's 13 names (JAX executor.py:179-193)
    "mae": ("masked_mae", {}),
    "mse": ("masked_mse", {}),
    "rmse": ("masked_rmse", {}),
    "mape": ("masked_mape", {}),
    "logcosh": ("log_cosh_loss", {}),
    "huber": ("huber_loss", {}),
    "quantile": ("quantile_loss", {}),
    "masked_mae": ("masked_mae", {"null_val": 0.0}),
    "masked_mse": ("masked_mse", {"null_val": 0.0}),
    "masked_rmse": ("masked_rmse", {"null_val": 0.0}),
    "masked_mape": ("masked_mape", {"null_val": 0.0}),
    "r2": ("r2_score", {}),
    "evar": ("explained_variance_score", {}),
}


def _pred_label(with_nan, seed=0):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(4, 6, 5, 1)).astype(np.float32) * 3 + 1
    labels = rng.normal(size=(4, 6, 5, 1)).astype(np.float32) * 3 + 1
    labels[0, :2] = 0.0         # null_val 0 entries
    labels[1, 0, 0] = 3e-5      # below min_s: thresholded to 0
    if with_nan:
        labels[2, 3] = np.nan   # NaN labels, masked when null_val is NaN
    return preds, labels


@pytest.mark.parametrize("with_nan", [False, True], ids=["zeros", "zeros_and_nan"])
@pytest.mark.parametrize("name", sorted(_LOSS_CALLS))
def test_losses_match_jax(name, with_nan):
    fn_name, kwargs = _LOSS_CALLS[name]
    preds, labels = _pred_label(with_nan)
    want = float(getattr(jax_losses, fn_name)(jnp.asarray(preds), jnp.asarray(labels), **kwargs))
    got = getattr(losses, fn_name)(torch.from_numpy(preds), torch.from_numpy(labels), **kwargs)
    assert got.dtype == torch.float32 and got.dim() == 0
    # NaN labels give NaN for the unmasked losses, and zero labels give
    # "mape" (null_val NaN) an infinite mean, as in JAX
    np.testing.assert_allclose(float(got), want, rtol=1e-6, equal_nan=True)
    if name.startswith("masked") or name in ("mae", "mse", "rmse"):
        assert math.isfinite(want), name


def test_masked_mape_with_eps_and_min_s_match_jax():
    preds, labels = _pred_label(True)
    for kwargs in ({"eps": 0.5}, {"min_s": 0.0}, {"null_val": 0.0, "min_s": 2.0}):
        want = float(jax_losses.masked_mape(preds, labels, **kwargs))
        np.testing.assert_allclose(float(losses.masked_mape(preds, labels, **kwargs)), want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["single", "average"])
def test_evaluator_metrics_match_jax(mode, tmp_path):
    metrics = ["MAE", "MAPE", "MSE", "RMSE", "masked_MAE", "masked_MAPE", "masked_MSE",
               "masked_RMSE", "R2", "EVAR"]
    config = {"metrics": metrics, "evaluator_mode": mode, "save_mode": ["csv", "json"],
              "model": "MultiATGCN", "dataset": "SYN"}
    preds, labels = _pred_label(False, seed=3)
    ours, theirs = TrafficStateEvaluator(config), JaxEvaluator(config)
    for ev in (ours, theirs):
        ev.collect({"y_true": labels, "y_pred": preds})
    got, want = ours.evaluate(), theirs.evaluate()
    assert set(got) == set(want) and len(got) == 6 * len(metrics)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    table = ours.save_result(str(tmp_path), "res")
    with open(tmp_path / "res.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == metrics and len(rows) == 7
    np.testing.assert_allclose([float(v) for v in rows[1]], [table[m][0] for m in metrics])
    frame = evaluate_model(preds, labels, metrics, mode, path=str(tmp_path / "m.csv"))
    np.testing.assert_allclose(frame["MAE"], table["MAE"], rtol=1e-6)


# ------------------------------------------------------------- optimizers


class _Cfg(dict):
    def get(self, k, d=None):
        return dict.get(self, k, d)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("learner,extra", [
    ("adam", {}), ("adam", {"weight_decay": 1e-2}), ("sgd", {}),
    ("sgd", {"lr_momentum": 0.9, "weight_decay": 1e-2}), ("adagrad", {"weight_decay": 1e-2}),
    ("rmsprop", {}), ("rmsprop", {"lr_momentum": 0.9}), ("unknown", {"weight_decay": 1e-2}),
])
def test_optimizer_steps_match_optax(learner, extra, clip):
    cfg = _Cfg(learner=learner, learning_rate=0.05, clip_grad_norm=clip, max_grad_norm=2.0, **extra)
    rng = np.random.default_rng(1)
    init = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in init.items()}
             for _ in range(5)]
    tx = jax_build_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = build_optimizer(cfg, params.values())
    norms = []
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = {k: jparams[k] + updates[k] for k in jparams}
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        if clip:
            norms.append(float(clip_by_global_norm(params.values(), 2.0)))
        opt.step()
    if clip:
        assert max(norms) > 2.0  # the clip fired
    for k in init:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)


def test_schedulers_match_jax_per_epoch():
    kinds = [("multisteplr", {"milestones": [2, 5, 7]}), ("steplr", {"step_size": 3}),
             ("exponentiallr", {}), ("cosineannealinglr", {"t_max": 6, "eta_min": 0.01}),
             ("lambdalr", {"lr_lambda": lambda e: 1.0 / (e + 1)}), ("none", {})]
    for kind, kw in kinds:
        ours, theirs = LRScheduler(kind, 0.1, decay_ratio=0.5, **kw), JaxLRScheduler(kind, 0.1, decay_ratio=0.5, **kw)
        assert [ours.lr_for_epoch(e) for e in range(10)] == [theirs.lr_for_epoch(e) for e in range(10)]
    ours = LRScheduler("reducelronplateau", 0.1, decay_ratio=0.5, patience=1)
    theirs = JaxLRScheduler("reducelronplateau", 0.1, decay_ratio=0.5, patience=1)
    for e, val in enumerate([1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8]):
        ours.step_plateau(val)
        theirs.step_plateau(val)
        assert ours.lr_for_epoch(e) == theirs.lr_for_epoch(e)
    assert ours.lr_for_epoch(9) < 0.1
    assert build_lr_scheduler(_Cfg(lr_decay=False)) is None
    assert build_lr_scheduler(_Cfg(lr_decay=True, lr_scheduler="bogus")) is None


# -------------------------------------------------------- executor end to end

TASK, MODEL, DATASET = "traffic_state_pred", "MultiATGCN", "SYN_TRAIN"
EPOCHS = 2


def _args(raw, out):
    """The 12-node recipe of the verify notes, with the multi-view graph."""
    return {
        "data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out,
        "exp_id": "train", "cache_dataset": False, "max_epoch": EPOCHS, "train_rate": 0.7,
        "eval_rate": 0.15, "input_window": 24, "output_window": 6, "load_external": True,
        "load_dynamic": False, "add_time_in_day": True, "groupstd": True, "add_static": True,
        "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
        "interval_trend": 4, "rnn_units": 16, "embed_dim_node": 4, "embed_dim_adj": 4,
        "adjtype": "multi", "adpadj": "bidirection", "batch_size": 8, "seed": 0,
    }


def _metrics_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["train_loss"]) for r in rows]),
            np.array([float(r["val_loss"]) for r in rows]))


def _trans_rows(eval_dir):
    (path,) = glob.glob(os.path.join(eval_dir, "*_trans.csv"))
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r[c]) for c in ("MAE", "MSE", "RMSE", "R2", "EVAR", "MAPE")] for r in rows])


# learner overrides -> (loss rtol, metric rtol); see the module docstring
LEARNERS = {"adam": ({}, 2e-5, 1e-3), "sgd": ({"learner": "sgd", "learning_rate": 0.01}, 1e-5, 1e-4)}


@pytest.fixture(scope="module", params=sorted(LEARNERS))
def trained(request, tmp_path_factory):
    """The JAX executor and the port's, trained 2 epochs from the same
    initial weights without dropout, then evaluated."""
    overrides, loss_rtol, metric_rtol = LEARNERS[request.param]
    root = str(tmp_path_factory.mktemp("port_training"))
    raw = os.path.join(root, "raw")
    make_synthetic_dataset(raw, DATASET, num_nodes=12, len_time=24 * 12, seed=3)

    jargs = dict(_args(raw, os.path.join(root, "jax")), **overrides)
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=jargs)
    jds = jax_get_dataset(jcfg)
    jtrain, jval, jtest = jds.get_data()
    jfeature = jds.get_data_feature()
    jmodel = jax_get_model(jcfg, jfeature).clone(dropout_rate=0.0)
    jexec = jax_get_executor(jcfg, jmodel, jfeature)
    init = {k: np.asarray(v) for k, v in jexec.params["params"].items()}
    jexec.train(jtrain, jval)
    jresult = jexec.evaluate(jtest)

    args = dict(_args(raw, os.path.join(root, "port")), **overrides)
    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    train, val, test = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature, device="cpu")
    model.dropout_rate = 0.0
    model.load_state_dict(state_dict_from_jax(init, model))
    executor = get_executor(cfg, model, feature, device="cpu")
    executor.train(train, val)
    result = executor.evaluate(test)
    return dict(root=root, args=args, jexec=jexec, jresult=jresult, executor=executor,
                result=result, test=test, feature=feature, cfg=cfg, loss_rtol=loss_rtol,
                metric_rtol=metric_rtol)


def test_executor_losses_per_epoch_match_jax(trained):
    got_train, got_val = _metrics_csv(trained["executor"]._metrics_log)
    want_train, want_val = _metrics_csv(trained["jexec"]._metrics_log)
    assert len(got_train) == len(want_train) == EPOCHS
    assert np.isfinite(got_train).all() and np.isfinite(got_val).all()
    np.testing.assert_allclose(got_train, want_train, rtol=trained["loss_rtol"])
    np.testing.assert_allclose(got_val, want_val, rtol=trained["loss_rtol"])


def test_executor_evaluation_matches_jax(trained):
    result, jresult = trained["result"], trained["jresult"]
    assert list(result) == list(jresult.columns)
    for metric in result:
        np.testing.assert_allclose(result[metric], jresult[metric].to_numpy(), rtol=trained["metric_rtol"],
                                   err_msg=metric)
    got = _trans_rows(trained["executor"].evaluate_res_dir)
    want = _trans_rows(trained["jexec"].evaluate_res_dir)
    assert got.shape == want.shape == (6, 6)
    np.testing.assert_allclose(got, want, rtol=trained["metric_rtol"])
    (npz,) = glob.glob(os.path.join(trained["executor"].evaluate_res_dir, "*_predictions_trans.npz"))
    with np.load(npz) as table:
        assert set(table.files) == {"prediction", "truth", "All_m", "All_std", "geo_id", "ahead_step",
                                    "prediction_t", "truth_t"}
        np.testing.assert_allclose(table["prediction_t"], table["prediction"] * table["All_std"] + table["All_m"],
                                   rtol=1e-6)


def test_checkpoint_reload_gives_identical_predictions(trained):
    executor, test = trained["executor"], trained["test"]
    before = executor.predict(test)
    epochs = sorted(glob.glob(os.path.join(executor.cache_dir, "*_epoch*.pt")))
    assert epochs, "no best-epoch checkpoint written"
    cfg = load_config(TASK, MODEL, DATASET, other_args=dict(trained["args"], epoch=len(epochs) - 1))
    fresh = get_executor(cfg, get_model(cfg, trained["feature"], device="cpu"), trained["feature"],
                         device="cpu")
    blob = torch.load(epochs[-1], weights_only=True)
    assert set(blob) == {"model", "optimizer", "epoch"}
    fresh.load_model_with_epoch(blob["epoch"])
    np.testing.assert_array_equal(fresh.predict(test), before)


def test_saved_model_serves_the_same_predictions(trained):
    executor, test, args = trained["executor"], trained["test"], trained["args"]
    cache = os.path.join(args["output_dir"], "train", "model_cache", "{}_{}.pt".format(MODEL, DATASET))
    executor.save_model(cache)
    service = PredictService.from_experiment(TASK, MODEL, DATASET, other_args=args, device="cpu")
    x = test.x[:5].numpy()
    mstd = trained["feature"]["ct_visit_mstd"]
    m = np.asarray(mstd["All_m"], np.float32)[None, None, :, None]
    s = np.asarray(mstd["All_std"], np.float32)[None, None, :, None]
    want = np.maximum(trained["feature"]["scaler"].inverse_transform(executor.predict(test)[:5]) * s + m, 0)
    np.testing.assert_allclose(service.predict(x), want, rtol=1e-5, atol=1e-4)


def test_run_model_cli_trains_saves_and_reuses_on_the_cpu(tmp_path):
    raw = str(tmp_path / "raw")
    make_synthetic_dataset(raw, DATASET, num_nodes=6, len_time=24 * 30, seed=1)
    args = ["--dataset", DATASET, "--exp_id", "cli", "--data_dir", raw,
            "--output_dir", str(tmp_path / "out"), "--input_window", "24", "--output_window", "6",
            "--rnn_units", "8", "--embed_dim_node", "3", "--embed_dim_adj", "3", "--batch_size", "8",
            "--compute_dtype", "bfloat16", "--weight_stream_quant", "int8"]
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text('{"max_epoch": 1, "len_closeness": 1, "len_period": 1, "len_trend": 1, '
                        '"interval_period": 2, "interval_trend": 4, "load_external": true, '
                        '"load_dynamic": false, "add_time_in_day": true, "cache_dataset": false}')
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        (trained_result,) = run_model_cli.main(args + ["--config_file", "cfg", "--device", "cpu"])
        # gpu false in the config means the CPU, as --device cpu does
        (reused,) = run_model_cli.main(args + ["--config_file", "cfg", "--train", "false", "--gpu", "false"])
    finally:
        os.chdir(cwd)
    out = tmp_path / "out" / "cli"
    assert (out / "model_cache" / "{}_{}.pt".format(MODEL, DATASET)).exists()
    assert (out / "train_metrics.csv").exists() and glob.glob(str(out / "events.out.tfevents.*"))
    assert glob.glob(str(out / "evaluate_cache" / "*_predictions.npz"))
    for metric, values in trained_result.items():
        # unmasked MAPE divides by the zero truths of the synthetic series
        assert metric == "MAPE" or np.isfinite(values).all(), metric
        np.testing.assert_array_equal(reused[metric], values)


def test_entry_points_raise_without_cuda(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = trained["executor"].model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_executor(trained["cfg"], model, trained["feature"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_model_cli.main(["--dataset", DATASET, "--data_dir", trained["args"]["data_dir"]])
    from multistgraph_tpu_torch import bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
