"""Multi-seed training (parallel/multiseed.py) on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. The file imports no
JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_multiseed_cuda.py
The small MultiATGCN of test_torch_port_graphs_cuda.py (12 nodes, hidden
16, 2 layers, 24 steps, batch 8) with dropout on, 2 seeds. The widened
step is captured after its eager warm-up, and its replays launch exactly
one seed's kernels. Each seed of 3 replays (and of one more with the
second seed's rate dropped tenfold, read by the same graph) is held against
a single-seed executor stepped on the card from that seed's slice of the
state (the rate-drop step from one state, copied in place), at
chip_smoke.py's MS_BOUND: the losses within the card-vs-CPU output bound
of the dtype (f32 1e-5, int8 5e-3), the parameters and Adam's moments
(exp_avg and the root of exp_avg_sq) within the larger of its two bounds
(1e-5, 3e-2). The batched contractions of the seeds may sum in another
order, and in int8 a flipped bf16 rounding moves an Adam step.
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
from multistgraph_tpu_torch.executor.optimizers import load_optimizer_state, set_learning_rate
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.parallel.multiseed import MultiSeedTrainer, train_multiseed

DATASET = "SYN_MULTISEED"
SEEDS = [0, 10]
REPLAYS = 3
MODES = {
    "int8": ({"compute_dtype": "bfloat16", "weight_stream_quant": "int8"},
             {"node_apply.node_apply_q8.launches": 96, "node_apply.node_apply_q8_t.launches": 96}),
    "f32": ({"compute_dtype": None},
            {"layout.force_default_layout.launches": 4, "layout.force_default_layout.backward_launches": 4}),
}
# (losses; parameters and Adam's moments): card-vs-CPU bounds of the dtype,
# as chip_smoke.py's MS_BOUND
BOUNDS = {"int8": (5e-3, 3e-2), "f32": (1e-5, 1e-5)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels run only on the card)")
    return torch.device("cuda")


def _setup(tmp_path, mode):
    raw = tmp_path / "raw"
    if not raw.exists():
        make_synthetic_dataset(str(raw), DATASET, num_nodes=12, len_time=24 * 35, seed=3)
    args = {"data_dir": str(raw), "output_dir": str(tmp_path / "out"), "exp_id": "multiseed",
            "cache_dataset": False, "input_window": 24, "output_window": 6, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "groupstd": True, "add_static": True,
            "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
            "interval_trend": 4, "rnn_units": 16, "embed_dim_node": 4, "embed_dim_adj": 4,
            "adjtype": "multi", "adpadj": "bidirection", "batch_size": 8, "num_layers": 2,
            "tensorboard": False, "learning_rate": 3e-3, "max_epoch": 1, "saved_model": False,
            **MODES[mode][0]}
    cfg = load_config("traffic_state_pred", "MultiATGCN", DATASET, other_args=args)
    ds = get_dataset(cfg)
    loaders = ds.get_data()
    feature = ds.get_data_feature()
    executor = get_executor(cfg, get_model(cfg, feature), feature)
    assert executor.model.dropout_rate > 0
    return cfg, feature, executor, loaders


def _rel(a, b):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _hold(trainer, i, ref, got, want, bounds):
    loss_bound, bound = bounds
    assert _rel(got, want) <= loss_bound
    for p, q in zip(trainer.model.members[i].parameters(), ref.model.parameters()):
        assert _rel(p.detach(), q.detach()) <= bound
    mine, theirs = trainer.seed_state(i)[1]["state"], ref.optimizer.state_dict()["state"]
    assert mine.keys() == theirs.keys()
    for j, st in mine.items():
        assert torch.equal(torch.as_tensor(st["step"]), torch.as_tensor(theirs[j]["step"]))
        assert _rel(st["exp_avg"], theirs[j]["exp_avg"]) <= bound
        assert _rel(st["exp_avg_sq"].sqrt(), theirs[j]["exp_avg_sq"].sqrt()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_widened_step_against_single_seed_steps(cuda, tmp_path, mode):
    cfg, feature, executor, (train, _, _) = _setup(tmp_path, mode)
    trainer = MultiSeedTrainer(executor, SEEDS)
    assert trainer.graphs_train
    rng = np.random.default_rng(0)
    steps = GRAPH_WARMUP_STEPS + REPLAYS + 1
    perm = np.stack([rng.permutation(train.num_samples)[: steps * 8].reshape(steps, 8) for _ in SEEDS], axis=1)
    rates = [3e-3] * len(SEEDS)
    set_learning_rate(trainer.optimizer, rates)
    trainer.train_steps(train, perm[:GRAPH_WARMUP_STEPS], tuple(rates))
    refs = []
    for i in range(len(SEEDS)):
        model_state, opt_state = trainer.seed_state(i)
        model = get_model(cfg, feature)
        model.load_state_dict(model_state)
        ref = get_executor(cfg, model, feature)
        load_optimizer_state(ref.optimizer, opt_state)
        ref.dropout_generator.set_state(trainer.generators[i].get_state())
        refs.append(ref)
    rows = perm[GRAPH_WARMUP_STEPS: GRAPH_WARMUP_STEPS + REPLAYS]
    got = trainer.train_steps(train, rows, tuple(rates))
    graph = trainer.graphs["train"]
    assert {k: v for k, v in graph.captured.items() if v} == MODES[mode][1]
    assert graph.replayed_launches() == {k: REPLAYS * v for k, v in MODES[mode][1].items()}
    for i, ref in enumerate(refs):
        set_learning_rate(ref.optimizer, rates[i])
        want = torch.stack([ref.train_step(ref.batch(train, idx)) for idx in rows[:, i]])
        _hold(trainer, i, ref, got[:, i], want, BOUNDS[mode])
    # the second seed's plateau drop: read by the same graph, its rate
    # alone, one step from one state (each seed's copied in place from its
    # single-seed run)
    with torch.no_grad():
        for member, ref in zip(trainer.model.members, refs):
            for p, q in zip(member.parameters(), ref.model.parameters()):
                p.copy_(q)
                for key, value in trainer.optimizer.state.get(p, {}).items():
                    value.copy_(ref.optimizer.state[q][key])
    rates[1] *= 0.1
    set_learning_rate(trainer.optimizer, rates)
    got = trainer.train_steps(train, perm[-1:], tuple(rates))
    assert trainer.graphs["train"] is graph and graph.replays == REPLAYS + 1
    for i, ref in enumerate(refs):
        set_learning_rate(ref.optimizer, rates[i])
        _hold(trainer, i, ref, got[0, i], ref.train_step(ref.batch(train, perm[-1, i])), BOUNDS[mode])


@pytest.mark.cuda
def test_cuda_train_multiseed_writes_checkpoints_the_executor_reads(cuda, tmp_path):
    cfg, feature, executor, (train, val, _) = _setup(tmp_path, "int8")
    results = train_multiseed(executor, train, val, SEEDS, save=True)
    for res in results:
        assert np.isfinite([h["train_loss"] for h in res.history]).all() and res.best_epoch == 0
        executor.load_model(res.checkpoint)
        assert np.isfinite(executor._valid_epoch(val))
