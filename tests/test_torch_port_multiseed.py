"""The port's multi-seed training (multistgraph_tpu_torch/parallel/multiseed.py)
against the JAX package's ``train_multiseed`` and against its own
single-seed executor, on the CPU.

The port's run starts from JAX's vmapped init (multiseed.py:96-98), read
from JAX's run and carried across per seed by ``state_dict_from_jax``; both run tests/test_multiseed.py's
SYN_SMALL arguments (2 seeds, 2 epochs, no dropout, no early stop) on a
12-day series, and JAX's ``train_multiseed`` runs once for the module.
Tolerances, each with its reason:
  * per-epoch losses against JAX: rtol 2e-5, the executor parity's Adam
    tolerance (tests/test_torch_port_training.py: optax's f32 bias
    corrections against torch's, a flipped step on a near-zero gradient);
    the saved best parameters rtol 2e-4, atol 2e-5, as JAX's own test
    holds its vmapped run against its sequential one;
  * each seed against the port's single-seed executor driven with the
    same shuffles: rtol 2e-6 on the losses (the same per-seed math; the
    seeds' batched contractions may sum in another order: the readings
    are below 5e-7) and atol 1e-6 on the parameters;
  * a forward and every gradient of two seeds against JAX's, per seed, at
    a tiny width: f32 atol 2e-5, rtol 2e-4 (another summation order), the
    int8 stream 5e-2 relative, the port's full-model BPTT bounds
    (tests/test_torch_port_bptt.py).
A multi-seed step on the card is tests/test_torch_port_multiseed_cuda.py.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu.models.multi_atgcn import make_loss_fn as jax_make_loss_fn
from multistgraph_tpu.parallel.multiseed import train_multiseed as jax_train_multiseed
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.loader import DeviceDataLoader
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import executor as executor_module
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.optimizers import build_optimizer, clip_grad_groups, set_learning_rate
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.parallel.multiseed import (
    MultiSeedTrainer,
    clip_each_seed,
    protocol_seeds,
    seed_cache_path,
    train_multiseed,
)
from multistgraph_tpu_torch.pipeline import run_model
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

SEEDS = [3, 7]
TASK, MODEL, DATASET = "traffic_state_pred", "MultiATGCN", "SYN_SMALL"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(raw, out, **over):
    """tests/test_multiseed.py:24-41's arguments."""
    args = {
        "data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out, "exp_id": "multiseed",
        "cache_dataset": False, "max_epoch": 2,
        "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2, "interval_trend": 4,
        "input_window": 24, "output_window": 3, "load_external": True, "load_dynamic": False,
        "add_time_in_day": True, "groupstd": True, "batch_size": 4, "train_rate": 0.7, "eval_rate": 0.15,
        "rnn_units": 4, "embed_dim_node": 2, "embed_dim_adj": 2, "use_early_stop": False,
        "saved_model": False, "load_best_epoch": False, "lr_decay": False, "seed": SEEDS[0],
        "tensorboard": False,
    }
    args.update(over)
    return args


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_multiseed"))
    make_synthetic_dataset(os.path.join(root, "raw"), DATASET, num_nodes=8, len_time=24 * 12, seed=7)
    return root


def _port(root, name, **over):
    """The port's config, executor (dropout off) and loaders."""
    cfg = load_config(TASK, MODEL, DATASET, other_args=_args(os.path.join(root, "raw"),
                                                              os.path.join(root, name), **over))
    ds = get_dataset(cfg, device="cpu")
    loaders = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature, device="cpu")
    model.dropout_rate = 0.0
    return cfg, get_executor(cfg, model, feature, device="cpu"), loaders


def _recording_first_jit(store):
    """jax.jit that keeps the output of the first program it compiles: in
    JAX's train_multiseed, the vmapped init (multiseed.py:96-98)."""
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if store:
            return compiled

        def call(*call_args):
            out = compiled(*call_args)
            store["init"] = jax.tree_util.tree_map(np.array, out)  # copies: the epoch donates them
            return out

        store["jit"] = True
        return call

    return jit


@pytest.fixture(scope="module")
def runs(raw):
    """JAX's train_multiseed and the port's, from the same initial weights."""
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=_args(os.path.join(raw, "raw"),
                                                                   os.path.join(raw, "jax")))
    jds = jax_get_dataset(jcfg)
    jtrain, jval, _ = jds.get_data()
    jfeature = jds.get_data_feature()
    jex = jax_get_executor(jcfg, jax_get_model(jcfg, jfeature).clone(dropout_rate=0.0), jfeature)
    store = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax, "jit", _recording_first_jit(store))
        jres = jax_train_multiseed(jex, jtrain, jval, SEEDS, save=True)
    params = store["init"]["params"]
    init = [{k: np.asarray(v[i]) for k, v in params.items()} for i in range(len(SEEDS))]

    cfg, ex, (train, val, test) = _port(raw, "port")
    states = [state_dict_from_jax(flat, ex.model) for flat in init]
    res = train_multiseed(ex, train, val, SEEDS, save=True, initial_states=states)
    return dict(jres=jres, res=res, cfg=cfg, ex=ex, train=train, val=val, test=test, states=states)


def test_multiseed_matches_jax(runs):
    for got, want in zip(runs["res"], runs["jres"]):
        assert got.seed == want.seed and len(got.history) == len(want.history) == 2
        for g, w in zip(got.history, want.history):
            assert g["epoch"] == w["epoch"] and g["lr"] == pytest.approx(w["lr"])
            np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=2e-5)
            np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=2e-5)
        assert got.best_epoch == want.best_epoch and got.stopped_epoch == want.stopped_epoch is None
        np.testing.assert_allclose(got.min_val_loss, want.min_val_loss, rtol=2e-5)
        # the saved best parameters, as JAX's test holds them
        model_state, opt_state = torch.load(got.checkpoint, weights_only=True)
        with open(want.checkpoint, "rb") as f:
            blob = flax.serialization.msgpack_restore(f.read())
        want_state = state_dict_from_jax({k: np.asarray(v) for k, v in blob["params"]["params"].items()},
                                         runs["ex"].model)
        assert set(model_state) == set(want_state)
        for name, value in want_state.items():
            np.testing.assert_allclose(model_state[name].numpy(), value.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        # the single-seed optimizer's form: one group, a state for each parameter the loss reaches
        assert opt_state["param_groups"][0]["params"] == list(range(len(model_state)))
        assert set(opt_state["state"]) <= set(range(len(model_state))) and len(opt_state["param_groups"]) == 1


def _single_seed_run(runs, i):
    """The port's single-seed executor from seed i's initial state, driven
    through the multi-seed run's shuffles: per-epoch (train, val) losses
    and the final parameters."""
    cfg, train, val = runs["cfg"], runs["train"], runs["val"]
    model = get_model(cfg, runs["ex"].data_feature, device="cpu")
    model.dropout_rate = 0.0
    model.load_state_dict(runs["states"][i])
    ex = get_executor(cfg, model, runs["ex"].data_feature, device="cpu")
    rng = np.random.default_rng(SEEDS[i])
    out = []
    for _ in range(cfg["max_epoch"]):
        order = np.arange(train.num_samples)
        rng.shuffle(order)
        perm = order[: len(train) * train.batch_size].reshape(len(train), train.batch_size)
        set_learning_rate(ex.optimizer, cfg.get("learning_rate", 0.01))
        out.append((float(ex.train_steps(train, perm, None).mean()), ex._valid_epoch(val)))
    return out, model


def test_each_seed_matches_its_single_seed_run(runs):
    for i, got in enumerate(runs["res"]):
        want, model = _single_seed_run(runs, i)
        np.testing.assert_allclose([[h["train_loss"], h["val_loss"]] for h in got.history], want, rtol=2e-6)
        if got.best_epoch == len(want) - 1:  # the saved state is the last epoch's
            saved, _ = torch.load(got.checkpoint, weights_only=True)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(saved[name].numpy(), p.detach().numpy(), rtol=0, atol=1e-6,
                                           err_msg=name)


def test_checkpoints_load_and_run_model_finds_them(runs, monkeypatch):
    cfg = runs["cfg"]
    for res in runs["res"]:
        assert res.checkpoint == seed_cache_path(cfg, res.seed)
        assert res.checkpoint.endswith(os.path.join("multiseed_{}".format(res.seed), "model_cache",
                                                    "MultiATGCN_SYN_SMALL.pt"))
        runs["ex"].load_model(res.checkpoint)
        saved, _ = torch.load(res.checkpoint, weights_only=True)
        assert all(torch.equal(p, saved[k]) for k, p in runs["ex"].model.state_dict().items())

    def no_training(self, *args):
        raise AssertionError("run_model --train false trained instead of loading the seed's checkpoint")

    monkeypatch.setattr(executor_module.TrafficStateExecutor, "train", no_training)
    args = _args(cfg["data_dir"], cfg["output_dir"], exp_id="multiseed_{}".format(SEEDS[1]), seed=SEEDS[1])
    result = run_model(TASK, MODEL, DATASET, saved_model=True, train=False, other_args=args, device="cpu")
    assert np.isfinite(result["masked_MAE"]).all()


def test_early_stop_bookkeeping(raw, monkeypatch):
    """Scripted validation losses: seed 3 stops at epoch 1 and keeps
    computing while seed 7 runs on to its stop at epoch 3, when the loop
    ends; each best snapshot is its best epoch's state, frozen."""
    scripted = [[1.0, 2.0, 2.0, 2.0, 2.0, 2.0], [3.0, 2.0, 1.0, 1.5, 1.6, 1.7]]
    snaps = []
    real_train_epoch = MultiSeedTrainer.train_epoch

    def train_epoch(self, *args):
        out = real_train_epoch(self, *args)
        snaps.append([{k: v.clone() for k, v in m.state_dict().items()} for m in self.model.members])
        return out

    monkeypatch.setattr(MultiSeedTrainer, "train_epoch", train_epoch)
    monkeypatch.setattr(MultiSeedTrainer, "valid_epoch",
                        lambda self, loader: np.array([s[len(snaps) - 1] for s in scripted]))
    _, ex, (train, val, _) = _port(raw, "early", max_epoch=6, use_early_stop=True, patience=1)
    short = DeviceDataLoader(train.x[:16].numpy(), train.y[:16].numpy(), train.batch_size, True)
    first, second = train_multiseed(ex, short, val, SEEDS, save=True)
    assert (first.stopped_epoch, first.best_epoch, len(first.history)) == (1, 0, 2)
    assert (second.stopped_epoch, second.best_epoch, len(second.history)) == (3, 2, 4)
    assert len(snaps) == 4  # until every seed stopped
    for res, i, epoch in ((first, 0, 0), (second, 1, 2)):
        saved, _ = torch.load(res.checkpoint, weights_only=True)
        assert all(torch.equal(saved[k], v) for k, v in snaps[epoch][i].items())
    # the stopped seed kept computing
    assert not torch.equal(snaps[3][0]["node_emb"], snaps[0][0]["node_emb"])


def test_sparse_atgcn_is_refused(tmp_path):
    cfg = load_config(TASK, "SparseATGCN", "SYN_LARGE", other_args={
        "output_dir": str(tmp_path), "exp_id": "sparse", "num_nodes": 200, "avg_degree": 8, "len_time": 40,
        "input_window": 4, "output_window": 2, "batch_size": 2, "rnn_units": 4, "embed_dim_adj": 3,
        "tensorboard": False})
    ds = get_dataset(cfg, device="cpu")
    train, val, _ = ds.get_data()
    ex = get_executor(cfg, get_model(cfg, ds.get_data_feature(), device="cpu"), ds.get_data_feature(),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="SparseATGCN"):
        train_multiseed(ex, train, val, SEEDS, save=False)


def test_clipping_is_each_seeds_own_global_norm():
    """Two seeds whose gradient norms differ 10x, against optax under vmap."""
    rng = np.random.default_rng(0)
    grads = [{"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}]
    grads.append({k: v * 10.0 for k, v in grads[0].items()})
    params = [[torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()] for g in grads]
    opt = build_optimizer({"learner": "adam", "learning_rate": 0.01}, [{"params": p} for p in params])
    for group, g in zip(params, grads):
        for p, v in zip(group, g.values()):
            p.grad = torch.tensor(v)
    max_norm = float(np.sqrt(sum(np.square(v).sum() for v in grads[0].values()))) * 3.0
    norms = clip_each_seed(opt, max_norm)
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
    clip = optax.clip_by_global_norm(max_norm)
    want = jax.vmap(lambda g: clip.update(g, clip.init(g))[0])(stacked)
    assert float(norms[1]) / float(norms[0]) == pytest.approx(10.0, rel=1e-5)
    for i, group in enumerate(params):
        for p, k in zip(group, grads[0]):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k][i]), rtol=1e-6, atol=1e-7)
    # seed 0 under the bound untouched, seed 1 cut to it
    np.testing.assert_array_equal(params[0][0].grad.numpy(), grads[0]["w"])


def test_clip_grad_groups_needs_as_many_gradients_in_each_group():
    """One pass over every group needs groups of one shape: a group with a
    gradient fewer is refused, and a group without gradients gives zeros."""
    params = [[torch.nn.Parameter(torch.ones(3)) for _ in range(2)] for _ in range(2)]
    for p in params[0] + params[1][:1]:
        p.grad = torch.ones(3)
    with pytest.raises(ValueError, match="as many"):
        clip_grad_groups(params, 1.0)
    empty = [[torch.nn.Parameter(torch.ones(3))] for _ in range(3)]
    assert torch.equal(clip_grad_groups(empty, 1.0), torch.zeros(3))


def _trainer_and_refs(runs, seeds_states, dropout=0.0):
    """A 2-seed trainer and one single-seed executor a seed, from the same
    states, the dropout generators seeded as the seeds."""
    cfg, feature = runs["cfg"], runs["ex"].data_feature
    base = get_model(cfg, feature, device="cpu")
    base.dropout_rate = dropout
    trainer = MultiSeedTrainer(get_executor(cfg, base, feature, device="cpu"), SEEDS, seeds_states)
    refs = []
    for seed, state in zip(SEEDS, seeds_states):
        model = get_model(cfg, feature, device="cpu")
        model.dropout_rate = dropout
        model.load_state_dict(state)
        ex = get_executor(cfg, model, feature, device="cpu")
        ex.dropout_generator.manual_seed(seed)
        refs.append(ex)
    return trainer, refs


def test_rates_and_dropout_stay_per_seed(runs):
    """One seed's plateau drop (its rate x 0.1) moves that seed's rate
    only; with dropout on, each seed draws its own generator's masks: both
    as the single-seed executors stepping at their own rates."""
    train = runs["train"]
    perm = [np.random.default_rng(s).permutation(train.num_samples)[: 3 * train.batch_size]
            .reshape(3, train.batch_size) for s in SEEDS]
    trainer, refs = _trainer_and_refs(runs, runs["states"], dropout=0.1)
    rates = [0.01, 0.001]
    set_learning_rate(trainer.optimizer, rates)
    assert [float(g["lr"]) for g in trainer.optimizer.param_groups] == rates
    got = trainer.train_steps(train, np.stack(perm, axis=1), tuple(rates))
    for i, ref in enumerate(refs):
        set_learning_rate(ref.optimizer, rates[i])
        want = ref.train_steps(train, perm[i], None)
        np.testing.assert_allclose(got[:, i].numpy(), want.numpy(), rtol=2e-6)
        for p, q in zip(trainer.model.members[i].parameters(), ref.model.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-6)
    # dropout was on: the same batch without it gives another loss
    with torch.no_grad():
        batch = refs[0].batch(train, perm[0][0])
        assert float(refs[0].loss_fn(batch, train=False)) != float(refs[0].loss_fn(batch, train=True))


def test_validation_and_predict_are_each_seeds_own(runs):
    """The widened validation and predict forwards: each seed's loss and
    predictions are its own model's on the loader's batches in order."""
    trainer, refs = _trainer_and_refs(runs, runs["states"])
    val = runs["val"]
    short = DeviceDataLoader(val.x[:8].numpy(), val.y[:8].numpy(), val.batch_size, False)
    losses, preds = trainer.valid_epoch(short), trainer.predict(short)
    assert losses.shape == (2,) and preds.shape[:2] == (2, 8)
    for i, ref in enumerate(refs):
        np.testing.assert_allclose(losses[i], ref._valid_epoch(short), rtol=2e-6)
        np.testing.assert_allclose(preds[i], ref.predict(short), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("form", [{}, {"compute_dtype": "bfloat16", "weight_stream_quant": "int8"}],
                         ids=["f32", "int8"])
def test_widened_forward_and_gradients_match_jax(runs, form):
    """Two seeds' losses and every parameter gradient through the trainer's
    widened forward (plain B2/B2t on the CPU for int8) against JAX's
    value_and_grad of each seed, at the module's tiny width."""
    args = _args(runs["cfg"]["data_dir"], runs["cfg"]["output_dir"], **form)
    cfg = load_config(TASK, MODEL, DATASET, other_args=args)
    jcfg = jax_load_config(TASK, MODEL, DATASET, other_args=args)
    jds = jax_get_dataset(jcfg)
    jds.get_data()
    jfeature = jds.get_data_feature()
    jmodel = jax_get_model(jcfg, jfeature)
    feature = runs["ex"].data_feature
    base = get_model(cfg, feature, device="cpu")
    assert base.uses_int8_stream == bool(form)
    train = runs["train"]
    x = train.x[: 2 * train.batch_size].numpy()
    y = train.y[: 2 * train.batch_size].numpy()
    shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False), jax.random.PRNGKey(0), x[:1])
    rng = np.random.default_rng(11)
    flats = [{k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
             for _ in SEEDS]
    trainer = MultiSeedTrainer(get_executor(cfg, base, feature, device="cpu"), SEEDS,
                               [state_dict_from_jax(f, base) for f in flats])
    xs = torch.from_numpy(x).unflatten(0, (2, -1))
    ys = torch.from_numpy(y).unflatten(0, (2, -1))
    losses = trainer.seed_loss(trainer.model(xs), ys)
    losses.sum().backward()
    loss_fn = jax_make_loss_fn(jmodel, jfeature["scaler"])
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, xx, yy: loss_fn({"params": p}, {"X": xx, "y": yy}, train=False)))
    tol = {"atol": 2e-5, "rtol": 2e-4} if not form else None
    for i, flat in enumerate(flats):
        want_v, want_g = value_and_grad(flat, xs[i].numpy(), ys[i].numpy())
        want_g = state_dict_from_jax({k: np.asarray(v) for k, v in want_g.items()}, base)
        np.testing.assert_allclose(float(losses[i].detach()), float(want_v), rtol=2e-4 if tol else 5e-2)
        for name, p in trainer.model.members[i].named_parameters():
            got = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            want = want_g[name].numpy()
            if tol:
                np.testing.assert_allclose(got, want, err_msg=name, **tol)
            else:
                assert np.abs(got - want).max() <= 5e-2 * max(np.abs(want).max(), 1e-12), name


def test_protocol_seeds_skip_the_protocol_values():
    assert protocol_seeds(4) == [0, 10, 100, 1000]
    assert protocol_seeds(8) == [0, 10, 100, 1000, 2, 3, 4, 5]
    assert len(set(protocol_seeds(20))) == 20 and 10 not in protocol_seeds(20)[4:]
