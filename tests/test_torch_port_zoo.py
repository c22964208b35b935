"""The port's model zoo (RNN/LSTM/GRU, FNN, Seq2Seq, AGCRN, TGCN, STGCN,
GWNET, DCRNN, ASTGCN, MSTGCN) against the JAX package.

Each family is built by both registries' builders at the JAX zoo tests'
tiny shapes (B=4, Tin=12, Tout=3, N=5, F=2), the JAX weights carried over
by ``state_dict_from_jax``; the forward and every parameter's gradient of
mean(out * w) (a mean, as the training losses are) are held to atol
1e-5, rtol 1e-4 (test_torch_port_model.py's limits), the JAX references
jitted. Also: the graph helpers bit for bit,
the configuration of all 12 names, TrafficStatePointDataset's splits,
DCRNN's teacher-forcing ratio, coins and forced ratios, GWNET's dropout,
and a short executor run of AGCRN and DCRNN against the JAX executor
(losses rtol 2e-5, metrics 1e-3, test_torch_port_training.py's Adam
limits). Nothing here needs the card; chip_smoke.py's zoo_phase runs the
zoo there.
"""

import csv
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.executor.executor import TrafficStateExecutor as JaxExecutor
from multistgraph_tpu.graph import laplacian as jax_laplacian
from multistgraph_tpu.models import conv_baselines as jax_conv
from multistgraph_tpu.models import graph_baselines as jax_graph
from multistgraph_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.config.parser import ConfigError
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.dataset import TrafficStatePointDataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.executor import teacher_forcing_ratio
from multistgraph_tpu_torch.graph import laplacian
from multistgraph_tpu_torch.models import MODEL_REGISTRY, conv_baselines, graph_baselines
from multistgraph_tpu_torch.models.dcrnn import sampling_coins
from multistgraph_tpu_torch.models.zoo import dropout
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

TASK = "traffic_state_pred"
B, TIN, TOUT, N, F = 4, 12, 3, 5, 2
ATOL, RTOL = 1e-5, 1e-4
ZOO = ("RNN", "LSTM", "GRU", "FNN", "Seq2Seq", "AGCRN", "TGCN", "STGCN", "GWNET", "DCRNN", "ASTGCN", "MSTGCN")

# each family's config at the tiny shapes (the builders' other keys keep their defaults)
CONFIGS = {
    "RNN": {"rnn_units": 8, "num_layers": 2, "rnn_type": "RNN"},
    "LSTM": {"rnn_units": 8, "num_layers": 2, "rnn_type": "LSTM"},
    "GRU": {"rnn_units": 8, "num_layers": 2, "rnn_type": "GRU"},
    "FNN": {"rnn_units": 8, "num_layers": 2},
    "Seq2Seq": {"rnn_units": 8},
    "AGCRN": {"rnn_units": 8, "num_layers": 2, "embed_dim_node": 3, "cheb_order": 3},
    "TGCN": {"rnn_units": 8},
    "STGCN": {"Ks": 3, "Kt": 3},
    "GWNET": {"residual_channels": 8, "dilation_channels": 8, "skip_channels": 16, "end_channels": 16,
              "blocks": 4, "layers": 2, "diffusion_order": 2, "embed_dim_adj": 4},
    "DCRNN": {"rnn_units": 8, "num_rnn_layers": 2, "max_diffusion_step": 2, "cl_decay_steps": 2000},
    "ASTGCN": {"nb_block": 2, "nb_filter": 8, "cheb_order": 3},
    "MSTGCN": {"nb_block": 2, "nb_filter": 8, "cheb_order": 3},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other training-heavy test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _adj(n=N, seed=1):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.5).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    return a


def _feature():
    return {"num_nodes": N, "feature_dim": F, "output_dim": 1, "adj_mx": _adj()}


def _config(name):
    return dict(CONFIGS[name], input_window=TIN, output_window=TOUT, seed=0)


def _flat(tree, prefix=""):
    """A flax parameter tree as flat "/"-joined names."""
    out = {}
    for key, value in tree.items():
        name = prefix + key
        if isinstance(value, dict):
            out.update(_flat(value, name + "/"))
        else:
            out[name] = np.asarray(value)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """(JAX module, its params, their flat names) of a family, built once."""
    jmodel = JAX_REGISTRY[_builder(name)](_config(name), _feature())
    x = jnp.zeros((B, TIN, N, F), jnp.float32)
    params = jax.jit(lambda k: jmodel.init(k, x))(jax.random.PRNGKey(0))
    return jmodel, params, _flat(params["params"])


def _builder(name):
    return "RNN" if name in ("LSTM", "GRU") else name


def _pair(name):
    """(JAX module, its params, a fresh port module carrying them)."""
    jmodel, params, flat = _jax_init(name)
    model = MODEL_REGISTRY[_builder(name)](_config(name), _feature(), device="cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return jmodel, params, model


def _torch_name(jax_name):
    """The flattening rule of utils/jax_import.py: a flax LayerNorm's
    ``b0_ln/scale`` and ``b0_ln/bias`` are ``b0_ln.weight`` and ``b0_ln.bias``."""
    if "/" not in jax_name:
        return jax_name
    module, leaf = jax_name.rsplit("/", 1)
    return module + "." + {"scale": "weight"}.get(leaf, leaf)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, TIN, N, F)).astype(np.float32)
    y = rng.normal(size=(B, TOUT, N, 1)).astype(np.float32)
    w = rng.normal(size=(B, TOUT, N, 1)).astype(np.float32)
    return x, y, w


def _hold_forward_and_grads(jmodel, params, model, apply_kwargs=None, port_kwargs=None):
    x, y, w = _inputs()
    apply_kwargs = apply_kwargs or {}

    def loss(p):
        out = jmodel.apply({**params, "params": p}, jnp.asarray(x), **apply_kwargs)
        return jnp.mean(out * w), out

    (_, want_out), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["params"])
    out = model(torch.from_numpy(x), **(port_kwargs or {}))
    (out * torch.from_numpy(w)).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL, rtol=RTOL)
    grads = _flat(want_grads)
    named = dict(model.named_parameters())
    assert len(grads) == len(named)
    for jname, g in grads.items():
        p = named[_torch_name(jname)]
        # a parameter the output does not reach (GWNET's last graph conv)
        # gets no gradient in torch and zeros in JAX
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, g, atol=ATOL, rtol=RTOL, err_msg=jname)
    return x, y


@pytest.mark.parametrize("name", ZOO)
def test_forward_and_gradients_match_jax(name):
    jmodel, params, model = _pair(name)
    _hold_forward_and_grads(jmodel, params, model)


def test_dcrnn_teacher_forced_matches_jax_and_ratio_zero_is_autoregressive():
    jmodel, params, model = _pair("DCRNN")
    x, y, _ = _inputs()
    targets = torch.from_numpy(y)
    gen = torch.Generator().manual_seed(0)
    # ratio 1: every coin takes the truth, in JAX and in the port
    _hold_forward_and_grads(
        jmodel, params, model,
        apply_kwargs={"train": True, "targets": jnp.asarray(y), "tf_ratio": 1.0,
                      "rngs": {"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)}},
        port_kwargs={"train": True, "targets": targets, "tf_ratio": torch.tensor(1.0), "generator": gen})
    with torch.no_grad():
        free = model(torch.from_numpy(x))
        forced = model(torch.from_numpy(x), train=True, targets=targets, tf_ratio=torch.tensor(1.0), generator=gen)
        none = model(torch.from_numpy(x), train=True, targets=targets, tf_ratio=torch.tensor(0.0), generator=gen)
        # a model without cl_decay_steps ignores the targets
        model.cl_decay_steps = 0
        off = model(torch.from_numpy(x), train=True, targets=targets, tf_ratio=torch.tensor(1.0), generator=gen)
    torch.testing.assert_close(none, free, rtol=0, atol=0)
    torch.testing.assert_close(off, free, rtol=0, atol=0)
    # step 0 starts from the GO symbol either way; later steps see the truth
    torch.testing.assert_close(forced[:, 0], free[:, 0], rtol=0, atol=0)
    assert not torch.equal(forced[:, 1:], free[:, 1:])


def test_dcrnn_coins_rate_and_teacher_forcing_ratio_match_jax():
    gen = torch.Generator().manual_seed(0)
    for rate in (0.0, 0.3, 0.9, 1.0):
        coins = sampling_coins(torch.tensor(rate), 24, 4096, gen, "cpu")
        assert coins.shape == (24, 4096, 1, 1) and coins.dtype == torch.bool
        assert abs(float(coins.float().mean()) - rate) < 0.01, rate
    # the JAX executor computes the ratio inside its jitted epoch program
    ns = SimpleNamespace(model=SimpleNamespace(cl_decay_steps=2000))
    steps = np.arange(10001)
    want = np.asarray(jax.jit(lambda s: JaxExecutor._tf_ratio(ns, s))(jnp.asarray(steps)))
    got = teacher_forcing_ratio(2000, steps)
    assert got.dtype == np.float32 and want.dtype == np.float32
    # numpy's f32 exp and XLA's differ in the last bit on a few steps (as
    # XLA's own jitted and eager ones do), which the sum and the division
    # carry to at most two units in the last place of the ratio
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.9
    assert got[0] == np.float32(2000) / np.float32(2001) and got[-1] < got[0]


def test_gwnet_dropout_rate_scale_and_generator():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    out = dropout(x, 0.3, True, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.all(out[kept] == torch.tensor(1.0) / 0.7)
    assert torch.equal(dropout(x, 0.3, False, gen), x)
    model = MODEL_REGISTRY["GWNET"](_config("GWNET"), _feature(), device="cpu")
    xb = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        a = model(xb, train=True, generator=torch.Generator().manual_seed(5))
        b = model(xb, train=True, generator=torch.Generator().manual_seed(5))
        c = model(xb, train=True, generator=torch.Generator().manual_seed(6))
        d = model(xb)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_graph_helpers_are_bit_identical():
    for seed in (1, 2):
        adj = _adj(9, seed) * np.random.default_rng(seed).random((9, 9)).astype(np.float32)
        adj[3] = 0.0   # a row of zero degree
        np.testing.assert_array_equal(laplacian.random_walk_matrix(adj), jax_laplacian.random_walk_matrix(adj))
        sl = laplacian.scaled_laplacian(adj, lambda_max=None, undirected=True)
        np.testing.assert_array_equal(sl, jax_laplacian.scaled_laplacian(adj, lambda_max=None, undirected=True))
        for order in (1, 2, 3, 4):
            for a, b in zip(laplacian.cheb_polynomials(sl, order), jax_laplacian.cheb_polynomials(sl, order),
                            strict=True):
                np.testing.assert_array_equal(a, b)
        for kind in ("laplacian", "random_walk", "dual_random_walk", "other"):
            for a, b in zip(laplacian.supports_by_filter_type(adj, kind),
                            jax_laplacian.supports_by_filter_type(adj, kind), strict=True):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(graph_baselines._sym_norm_adj(adj), jax_graph._sym_norm_adj(adj))
        np.testing.assert_array_equal(conv_baselines._cheb_supports(adj, 3), jax_conv._cheb_supports(adj, 3))
        for a, b in zip(conv_baselines._random_walk_supports(adj), jax_conv._random_walk_supports(adj), strict=True):
            np.testing.assert_array_equal(a, b)


def test_config_of_every_zoo_name_matches_jax(tmp_path):
    for name in ZOO:
        args = {"data_dir": str(tmp_path), "seed": 3}
        ours = load_config(TASK, name, "SYN_ZOO", other_args=args).to_dict()
        ref = jax_load_config(TASK, name, "SYN_ZOO", other_args=args).to_dict()
        shared = set(ours) & set(ref)
        assert set(ref) - shared <= {"pallas_interpret"} and shared == set(ours), name
        assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}, name
        assert ours["dataset_class"] == "TrafficStatePointDataset"
    assert load_config(TASK, "LSTM", "SYN_ZOO")["rnn_type"] == "LSTM"
    # the families still to port fail in the parser
    with pytest.raises(ConfigError):
        load_config(TASK, "MTGNN", "SYN_ZOO")


def test_point_dataset_matches_jax(synthetic_dataset, tmp_path):
    args = {"data_dir": synthetic_dataset, "cache_dir": str(tmp_path / "cache"), "input_window": 12,
            "output_window": 3, "train_rate": 0.7, "eval_rate": 0.15, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "batch_size": 4, "seed": 0}
    ours = get_dataset(load_config(TASK, "AGCRN", "SYN_SMALL", other_args=args), device="cpu")
    ref = jax_get_dataset(jax_load_config(TASK, "AGCRN", "SYN_SMALL", other_args=args))
    assert isinstance(ours, TrafficStatePointDataset) and type(ref).__name__ == "TrafficStatePointDataset"
    for ol, rl in zip(ours.get_data(), ref.get_data(), strict=True):
        assert ol.x.shape[1] == 12
        np.testing.assert_array_equal(ol.x.numpy(), np.asarray(rl.x))
        np.testing.assert_array_equal(ol.y.numpy(), np.asarray(rl.y))
        np.testing.assert_array_equal(ol.epoch_permutation(), rl.epoch_permutation())
    fo, fr = ours.get_data_feature(), ref.get_data_feature()
    for key in ("ext_dim", "num_nodes", "feature_dim", "output_dim", "num_batches"):
        assert fo[key] == fr[key], key
    np.testing.assert_allclose(fo["scaler"].mean, fr["scaler"].mean, rtol=1e-12)
    np.testing.assert_allclose(fo["scaler"].std, fr["scaler"].std, rtol=1e-12)
    assert os.path.basename(ours.cache_file_name).startswith("torch_point_")


# ------------------------------------------------- executor against JAX's

EXEC_DATASET = "SYN_ZOO_TRAIN"


def _exec_args(raw, out, name):
    args = {"data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out, "exp_id": name,
            "cache_dataset": False, "max_epoch": 2, "train_rate": 0.7, "eval_rate": 0.15, "input_window": 6,
            "output_window": 3, "load_external": True, "load_dynamic": False, "add_time_in_day": True,
            "batch_size": 16, "rnn_units": 8, "seed": 0, "tensorboard": False}
    if name == "AGCRN":
        args.update(embed_dim_node=3, num_layers=1)
    else:
        args.update(cl_decay_steps=0, max_diffusion_step=1, num_rnn_layers=1)
    return args


def _losses(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r["train_loss"]), float(r["val_loss"])] for r in rows])


@pytest.mark.parametrize("name", ["AGCRN", "DCRNN"])
def test_executor_matches_jax(name, tmp_path):
    raw = str(tmp_path / "raw")
    make_synthetic_dataset(raw, EXEC_DATASET, num_nodes=6, len_time=24 * 8, seed=3)
    jcfg = jax_load_config(TASK, name, EXEC_DATASET, other_args=_exec_args(raw, str(tmp_path / "jax"), name))
    jds = jax_get_dataset(jcfg)
    jtrain, jval, jtest = jds.get_data()
    jfeature = jds.get_data_feature()
    jexec = jax_get_executor(jcfg, JAX_REGISTRY[name](jcfg, jfeature), jfeature)
    init = _flat(jexec.params["params"])
    jexec.train(jtrain, jval)
    jresult = jexec.evaluate(jtest)

    cfg = load_config(TASK, name, EXEC_DATASET, other_args=_exec_args(raw, str(tmp_path / "port"), name))
    ds = get_dataset(cfg, device="cpu")
    train, val, test = ds.get_data()
    feature = ds.get_data_feature()
    model = MODEL_REGISTRY[name](cfg, feature, device="cpu")
    model.load_state_dict(state_dict_from_jax(init, model))
    executor = get_executor(cfg, model, feature, device="cpu")
    assert executor.tf_ratio is None
    executor.train(train, val)
    result = executor.evaluate(test)

    got, want = _losses(executor._metrics_log), _losses(jexec._metrics_log)
    assert got.shape == want.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for metric in result:
        np.testing.assert_allclose(result[metric], jresult[metric].to_numpy(), rtol=1e-3, err_msg=metric)


def test_executor_scheduled_sampling_steps(tmp_path):
    """DCRNN's train steps read the ratio of their global step; validation
    rolls out autoregressively."""
    raw = str(tmp_path / "raw")
    make_synthetic_dataset(raw, EXEC_DATASET, num_nodes=6, len_time=24 * 8, seed=3)
    args = dict(_exec_args(raw, str(tmp_path / "port"), "DCRNN"), cl_decay_steps=3, max_epoch=1)
    cfg = load_config(TASK, "DCRNN", EXEC_DATASET, other_args=args)
    ds = get_dataset(cfg, device="cpu")
    train, val, _ = ds.get_data()
    executor = get_executor(cfg, MODEL_REGISTRY["DCRNN"](cfg, ds.get_data_feature(), device="cpu"),
                            ds.get_data_feature(), device="cpu")
    assert float(executor.tf_ratio) == teacher_forcing_ratio(3, 0)
    executor.train(train, val)
    assert executor.global_step == len(train)
    assert float(executor.tf_ratio) == teacher_forcing_ratio(3, len(train) - 1)
    # the loss in train mode depends on the coins; in eval mode it does not
    batch = executor.batch(train, train.ordered_permutation()[0])
    with torch.no_grad():
        executor.tf_ratio.fill_(1.0)
        forced = executor.loss_fn(batch, train=True, generator=torch.Generator().manual_seed(0))
        executor.tf_ratio.fill_(0.0)
        free = executor.loss_fn(batch, train=True, generator=torch.Generator().manual_seed(0))
        assert float(free) == float(executor.loss_fn(batch, train=False))
    assert float(forced) != float(free)
