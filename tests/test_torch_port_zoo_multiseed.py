"""The model zoo under the port's multi-seed training
(multistgraph_tpu_torch/parallel/multiseed.py, the "members" form: each
seed's own forward, generator, loss, clip and Adam group in one step), on
the CPU.

  * JAX's ``train_multiseed`` (which vmaps the zoo's families) against the
    port's for GRU, DCRNN (without scheduled sampling) and GMAN: 2 seeds, 2
    epochs, dropout 0, the port starting from JAX's vmapped init carried by
    ``state_dict_from_jax``; the tolerances of
    tests/test_torch_port_multiseed.py: per-epoch losses rtol 2e-5 (optax's
    f32 Adam against torch's), the saved best parameters rtol 2e-4, atol
    2e-5, as JAX's own test holds its vmapped run against its sequential
    one;
  * every one of the 18 names at tiny widths, torch only: each seed of
    ``train_multiseed`` (2 seeds, 1 epoch of 3 batches, clipping on, each
    family's dropout at its default, DCRNN's scheduled sampling on) against
    the port's single-seed executor at that seed driven with the same
    shuffles: losses, validation, the saved parameters, Adam's state and
    the predictions bit for bit (the members form runs each seed's
    arithmetic unchanged);
  * each seed's dropout draws from its own generator at the family's rate
    (GWNET, MTGNN), DCRNN's coins from each seed's generator with the one
    ratio of the global step; a seed handed another's generator breaks the
    equality (a planted fault);
  * a zoo seed's checkpoint is read by ``run_model --train false``.
JAX's runs are jitted, as its executor runs them. One torch thread.
"""

import os

import jax
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.models import get_model as jax_get_model
from multistgraph_tpu.parallel.multiseed import train_multiseed as jax_train_multiseed
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.config.defaults import ZOO_MODELS
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.loader import DeviceDataLoader
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import executor as executor_module
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.executor import teacher_forcing_ratio
from multistgraph_tpu_torch.models import conv_baselines, dcrnn, get_model, mtgnn
from multistgraph_tpu_torch.parallel.multiseed import MultiSeedTrainer, SeedMembers, train_multiseed
from multistgraph_tpu_torch.pipeline import run_model
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

TASK, DATASET = "traffic_state_pred", "SYN_ZOO_MS"
SEEDS = [3, 7]
BATCH, STEPS = 8, 3

# each family at a tiny width (the other keys at their defaults)
TINY = {
    "RNN": {"rnn_units": 4}, "LSTM": {"rnn_units": 4}, "GRU": {"rnn_units": 4}, "FNN": {"rnn_units": 4},
    "Seq2Seq": {"rnn_units": 4}, "AGCRN": {"rnn_units": 4, "embed_dim_node": 3, "num_layers": 1},
    "TGCN": {"rnn_units": 4}, "STGCN": {"Ks": 2, "Kt": 3},
    "GWNET": {"residual_channels": 4, "dilation_channels": 4, "skip_channels": 8, "end_channels": 8,
              "blocks": 2, "layers": 2, "embed_dim_adj": 3},
    "DCRNN": {"rnn_units": 4, "num_rnn_layers": 1, "max_diffusion_step": 1, "cl_decay_steps": 3},
    "ASTGCN": {"nb_block": 1, "nb_filter": 4, "cheb_order": 2},
    "MSTGCN": {"nb_block": 1, "nb_filter": 4, "cheb_order": 2},
    "MTGNN": {"embed_dim_node": 3, "subgraph_size": 3, "conv_channels": 4, "residual_channels": 4,
              "skip_channels": 4, "end_channels": 8, "layers": 1},
    "STSGCN": {"rnn_units": 4, "gcn_depth": 1, "num_layers": 1},
    "STTN": {"rnn_units": 4, "num_heads": 2, "num_blocks": 1, "ffn_dim": 8},
    "GMAN": {"num_heads": 2, "head_dim": 2, "num_blocks": 1, "se_dim": 3},
    "STGODE": {"rnn_units": 4, "stgode_blocks": 1, "ode_steps": 2, "stgode_head_dim": 8, "stgode_dtw_band": 3,
               "stgode_sparsity": 0.3},
    "STGNCDE": {"rnn_units": 4, "ncde_field_dim": 4, "embed_dim_node": 3, "cheb_order": 2, "ncde_substeps": 1},
}
# JAX's train_multiseed against the port's: DCRNN without scheduled sampling
JAX_CASES = {"GRU": {"rnn_units": 4}, "DCRNN": dict(TINY["DCRNN"], cl_decay_steps=0),
             "GMAN": TINY["GMAN"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other training-heavy test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoo_multiseed"))
    make_synthetic_dataset(os.path.join(root, "raw"), DATASET, num_nodes=5, len_time=24 * 6, seed=4)
    return root


def _args(root, name, out="port", **over):
    args = {"data_dir": os.path.join(root, "raw"), "cache_dir": os.path.join(root, out, "cache"),
            "output_dir": os.path.join(root, out), "exp_id": "ms_" + name, "cache_dataset": False,
            "max_epoch": 2, "input_window": 12, "output_window": 3, "load_external": True, "load_dynamic": False,
            "add_time_in_day": True, "batch_size": BATCH, "train_rate": 0.7, "eval_rate": 0.15,
            "use_early_stop": False, "saved_model": False, "load_best_epoch": False, "lr_decay": False,
            "seed": SEEDS[0], "tensorboard": False}
    args.update(over)
    return args


def _port(root, name, **over):
    cfg = load_config(TASK, name, DATASET, other_args=_args(root, name, **over))
    ds = get_dataset(cfg, device="cpu")
    loaders = ds.get_data()
    feature = ds.get_data_feature()
    return cfg, feature, loaders, get_executor(cfg, get_model(cfg, feature, device="cpu"), feature, device="cpu")


def _flat(tree, prefix=""):
    """A flax parameter tree as flat "/"-joined names."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


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


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_zoo_multiseed_matches_jax(raw, name):
    over = dict(JAX_CASES[name], saved_model=True)
    jcfg = jax_load_config(TASK, name, DATASET, other_args=_args(raw, name, out="jax", **over))
    jds = jax_get_dataset(jcfg)
    jtrain, jval, _ = jds.get_data()
    jfeature = jds.get_data_feature()
    jex = jax_get_executor(jcfg, jax_get_model(jcfg, jfeature), jfeature)
    store = {}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax, "jit", _recording_first_jit(store))
        jres = jax_train_multiseed(jex, jtrain, jval, SEEDS, save=True)
    flat = _flat(store["init"]["params"])

    cfg, _, (train, val, _), ex = _port(raw, name, **over)
    states = [state_dict_from_jax({k: v[i] for k, v in flat.items()}, ex.model) for i in range(len(SEEDS))]
    res = train_multiseed(ex, train, val, SEEDS, save=True, initial_states=states)
    for got, want in zip(res, jres):
        assert got.seed == want.seed and len(got.history) == len(want.history) == 2
        for g, w in zip(got.history, want.history):
            np.testing.assert_allclose([g["train_loss"], g["val_loss"]], [w["train_loss"], w["val_loss"]],
                                       rtol=2e-5)
        assert got.best_epoch == want.best_epoch
        saved, _ = torch.load(got.checkpoint, weights_only=True)
        import flax.serialization

        with open(want.checkpoint, "rb") as f:
            blob = flax.serialization.msgpack_restore(f.read())
        want_state = state_dict_from_jax(_flat(blob["params"]["params"]), ex.model)
        assert set(saved) == set(want_state)
        for key, value in want_state.items():
            np.testing.assert_allclose(saved[key].numpy(), value.numpy(), rtol=2e-4, atol=2e-5, err_msg=key)


def _single_seed(cfg, feature, seed, train, val, num_epochs):
    """The port's single-seed executor at `seed` (weights drawn at `seed`,
    dropout and coins from its generator seeded with it), driven through
    the multi-seed run's shuffles; per-epoch (train, val) losses."""
    model = get_model(cfg, feature, device="cpu", generator=torch.Generator().manual_seed(seed))
    ex = get_executor(cfg, model, feature, device="cpu")
    ex.dropout_generator.manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = []
    for epoch in range(num_epochs):
        order = np.arange(train.num_samples)
        rng.shuffle(order)
        ex.global_step = epoch * len(train)
        perm = order[: len(train) * train.batch_size].reshape(len(train), train.batch_size)
        out.append([float(ex.train_steps(train, perm, None).mean()), ex._valid_epoch(val)])
    return out, ex


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_each_seed_is_its_single_seed_run_bit_for_bit(raw, name):
    cfg, feature, (train, val, _), ex = _port(raw, name, max_epoch=1, saved_model=True, clip_grad_norm=True,
                                              max_grad_norm=0.5, **TINY[name])
    short = DeviceDataLoader(train.x[: STEPS * BATCH].numpy(), train.y[: STEPS * BATCH].numpy(), BATCH, True)
    head = DeviceDataLoader(val.x[:BATCH].numpy(), val.y[:BATCH].numpy(), BATCH, False)
    trainer = MultiSeedTrainer(ex, SEEDS)
    assert trainer.form == "members" and isinstance(trainer.model, SeedMembers)
    results = train_multiseed(ex, short, head, SEEDS, save=True, trainer=trainer)
    preds = trainer.predict(head)
    for i, (res, seed) in enumerate(zip(results, SEEDS)):
        want, ref = _single_seed(cfg, feature, seed, short, head, 1)
        assert [[h["train_loss"], h["val_loss"]] for h in res.history] == want, seed
        saved, opt = torch.load(res.checkpoint, weights_only=True)
        for key, p in ref.model.state_dict().items():
            assert torch.equal(saved[key], p), (seed, key)
        theirs = ref.optimizer.state_dict()["state"]
        assert set(opt["state"]) == set(theirs)
        for j, st in opt["state"].items():
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(torch.as_tensor(st[k]), torch.as_tensor(theirs[j][k])), (seed, j, k)
        assert np.array_equal(preds[i], ref.predict(head)), seed


def test_dropout_and_coins_come_from_each_seeds_generator(raw, monkeypatch):
    """GWNET's and MTGNN's dropout at the family's rate and DCRNN's coins
    with the shared ratio, each member drawing from its own generator;
    seed 1 handed seed 0's generator and seed 0's weights and batch
    repeats seed 0 (the planted fault a per-seed hold must catch)."""
    calls = []

    def recording(fn, kind):
        def wrapped(*args, **kwargs):
            calls.append((kind, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(conv_baselines, "dropout", recording(conv_baselines.dropout, "dropout"))
    monkeypatch.setattr(mtgnn, "dropout", recording(mtgnn.dropout, "dropout"))
    monkeypatch.setattr(dcrnn, "sampling_coins", recording(dcrnn.sampling_coins, "coins"))
    for name in ("GWNET", "MTGNN", "DCRNN"):
        _, _, (train, _, _), ex = _port(raw, name, **TINY[name])
        state = ex.model.state_dict()
        trainer = MultiSeedTrainer(ex, SEEDS, [state, state])
        idx = train.ordered_permutation()[0]
        batch = trainer.batch(train, np.stack([idx, idx]))
        trainer.global_step = 5
        del calls[:]
        trainer.before_train_step()
        trainer.train_step(batch)
        per_member = len(calls) // 2
        assert per_member > 0 and len(calls) == 2 * per_member
        for i in range(2):
            for kind, args, _ in calls[i * per_member: (i + 1) * per_member]:
                if kind == "dropout":   # (x, rate, train, generator)
                    assert args[1] == ex.model.dropout > 0 and args[2] is True
                    assert args[3] is trainer.generators[i], name
                else:                   # (tf_ratio, output_window, batch, generator, device)
                    assert args[0] is trainer.tf_ratio and args[3] is trainer.generators[i]
                    assert float(args[0]) == teacher_forcing_ratio(3, 5)
        # the same weights (the step moved each seed's its own way) and batch:
        # each seed's own draws part the outputs; seed 1 with seed 0's
        # generator state repeats seed 0's
        for member in trainer.model.members:
            member.load_state_dict(state)
        with torch.no_grad():
            for g, s in zip(trainer.generators, SEEDS):
                g.manual_seed(s)
            extra = {"targets": batch["y"][..., :1], "tf_ratio": trainer.tf_ratio} if name == "DCRNN" else {}
            own = trainer.model(batch["X"], train=True, generators=trainer.generators, **extra)
            shared = trainer.model(batch["X"], train=True, generators=(torch.Generator().manual_seed(SEEDS[0]),
                                                                       torch.Generator().manual_seed(SEEDS[0])),
                                   **extra)
        assert not torch.equal(own[0], own[1]), name
        assert torch.equal(shared[0], shared[1]) and torch.equal(shared[0], own[0]), name


def test_zoo_seed_checkpoint_is_read_by_run_model(raw, monkeypatch):
    cfg, _, (train, val, _), ex = _port(raw, "GRU", max_epoch=1, saved_model=True, **TINY["GRU"])
    short = DeviceDataLoader(train.x[: STEPS * BATCH].numpy(), train.y[: STEPS * BATCH].numpy(), BATCH, True)
    results = train_multiseed(ex, short, val, SEEDS, save=True, model_name="GRU")
    loaded = {}

    def no_training(self, *args):
        raise AssertionError("run_model --train false trained instead of loading the seed's checkpoint")

    real_load = executor_module.TrafficStateExecutor.load_model

    def load_model(self, cache_name):
        real_load(self, cache_name)
        loaded[cache_name] = {k: v.clone() for k, v in self.model.state_dict().items()}

    monkeypatch.setattr(executor_module.TrafficStateExecutor, "train", no_training)
    monkeypatch.setattr(executor_module.TrafficStateExecutor, "load_model", load_model)
    res = results[1]
    # the checkpoint has the name the pipeline was called with ("GRU"),
    # not the config's model class ("RNN")
    assert res.checkpoint.endswith(os.path.join("ms_GRU_7", "model_cache", "GRU_{}.pt".format(DATASET)))
    args = _args(raw, "GRU", max_epoch=1, exp_id="ms_GRU_{}".format(res.seed), seed=res.seed, **TINY["GRU"])
    result = run_model(TASK, "GRU", DATASET, saved_model=True, train=False, other_args=args, device="cpu")
    assert np.isfinite(result["masked_MAE"]).all()
    saved, _ = torch.load(res.checkpoint, weights_only=True)
    assert list(loaded) == [res.checkpoint]
    assert all(torch.equal(saved[k], v) for k, v in loaded[res.checkpoint].items())
