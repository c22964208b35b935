"""The executor's and the service's CUDA graphs on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. The file imports no
JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_graphs_cuda.py
The small MultiATGCN of test_torch_port_training_cuda.py (12 nodes, hidden
16, 2 layers, 24 steps, batch 8) with dropout on. A graphed run and an
eager one start from the same weights, optimizer and dropout generator
state, and must agree bit for bit: the losses, every parameter and the
optimizer's state after the replays, the validation loss and predictions,
and the service's replies.

SparseATGCN (SYN_LARGE_TINY at 300 nodes; the BSR form, the tail form and
the band on packed rows, each with the adaptive view, in f32 and bf16) is
held the same way where its eager steps are bit-reproducible. Its atomic
sums (the tail's index_add_, the backward of index_select on hub and tail
columns) change from run to run, so each graphed result is held
against 5 eager runs from the same state: bit for bit where they agree bit
for bit, else within twice the largest gap between two of them.
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.executor.executor import GRAPH_WARMUP_STEPS
from multistgraph_tpu_torch.executor.optimizers import set_learning_rate
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.serving import PredictService

DATASET = "SYN_GRAPHS"
REPLAYS = 3
MODES = {
    "int8": {"compute_dtype": "bfloat16", "weight_stream_quant": "int8"},
    "int8 f32": {"compute_dtype": "float32", "weight_stream_quant": "int8"},
    "bf16": {"compute_dtype": "bfloat16"},
    "f32": {"compute_dtype": None},
}
# the kernels one captured train step launches (96 = 2 launches x 24 steps x 2 layers)
CAPTURED = {
    "int8": {"node_apply.node_apply_q8.launches": 96, "node_apply.node_apply_q8_t.launches": 96},
    "int8 f32": {"node_apply.node_apply_q8.launches_f32": 96, "node_apply.node_apply_q8_t.launches_f32": 96},
    "bf16": {},
    "f32": {"layout.force_default_layout.launches": 4, "layout.force_default_layout.backward_launches": 4},
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the kernels run only on the card)")
    return torch.device("cuda")


class _First:
    """The first `k` batches of a loader's permutation, on its split."""

    def __init__(self, loader, k, ordered=False):
        self.x, self.y, self.batch_size = loader.x, loader.y, loader.batch_size
        perm = loader.ordered_permutation() if ordered else loader.epoch_permutation()
        self._perm = perm[:k]

    def __len__(self):
        return len(self._perm)

    def epoch_permutation(self):
        return self._perm

    ordered_permutation = epoch_permutation


def _executors(tmp_path, mode, learner=None, n=2):
    """`n` executors of the small model in `mode` on the card, with the same
    weights, optimizer and dropout seed; and the data loaders."""
    raw = tmp_path / "raw"
    if not raw.exists():
        make_synthetic_dataset(str(raw), DATASET, num_nodes=12, len_time=24 * 35, seed=3)
    args = {"data_dir": str(raw), "output_dir": str(tmp_path / "out"), "exp_id": "graphs",
            "cache_dataset": False, "input_window": 24, "output_window": 6, "load_external": True,
            "load_dynamic": False, "add_time_in_day": True, "groupstd": True, "add_static": True,
            "len_closeness": 1, "len_period": 1, "len_trend": 1, "interval_period": 2,
            "interval_trend": 4, "rnn_units": 16, "embed_dim_node": 4, "embed_dim_adj": 4,
            "adjtype": "multi", "adpadj": "bidirection", "batch_size": 8, "num_layers": 2,
            "tensorboard": False, "learning_rate": 3e-3, **MODES[mode]}
    if learner:
        args["learner"] = learner
    cfg = load_config("traffic_state_pred", "MultiATGCN", DATASET, other_args=args)
    ds = get_dataset(cfg)
    loaders = ds.get_data()
    feature = ds.get_data_feature()
    state = get_model(cfg, feature, generator=torch.Generator().manual_seed(0)).state_dict()
    executors = []
    for _ in range(n):
        model = get_model(cfg, feature)
        model.load_state_dict(state)
        executors.append(get_executor(cfg, model, feature))
    assert executors[0].model.dropout_rate > 0
    return executors, loaders


def _eager_epoch(executor, loader, lr):
    """The eager counterpart of train_epoch: train_step over the batches."""
    set_learning_rate(executor.optimizer, lr)
    losses = [executor.train_step(executor.batch(loader, idx)) for idx in loader.epoch_permutation()]
    return float(torch.stack(losses).mean())


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for k, state in sa["state"].items():
        for key, value in state.items():
            assert torch.equal(torch.as_tensor(value), torch.as_tensor(sb["state"][k][key])), (k, key)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_replayed_steps_are_bit_identical_to_eager_steps(cuda, tmp_path, mode):
    (graphed, eager), (train, _, _) = _executors(tmp_path, mode)
    assert graphed.graphs_train
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    got = graphed.train_epoch(batches, 3e-3)
    want = _eager_epoch(eager, batches, 3e-3)
    torch.cuda.synchronize()
    graph = graphed.graphs["train"]
    assert graph.replays == REPLAYS
    assert got == want
    _assert_same_state(graphed, eager)
    # the counters hold the eager warm-up's launches only; the graph the rest
    assert graph.captured == CAPTURED[mode]
    assert graph.replayed_launches() == {k: REPLAYS * v for k, v in CAPTURED[mode].items()}


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["adam", "rmsprop", "sgd"])
def test_cuda_replay_after_set_learning_rate_uses_the_new_rate(cuda, tmp_path, learner):
    (graphed, eager), (train, _, _) = _executors(tmp_path, "int8", learner=learner)
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    for lr in (3e-3, 1e-3):
        assert graphed.train_epoch(batches, lr) == _eager_epoch(eager, batches, lr)
    _assert_same_state(graphed, eager)
    assert graphed.graphs["train"].replays == (REPLAYS + len(batches) if learner != "sgd" else len(batches))


@pytest.mark.cuda
def test_cuda_replay_after_load_model_with_epoch_is_recaptured(cuda, tmp_path):
    (graphed, eager), (train, _, _) = _executors(tmp_path, "int8")
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    graphed.train_epoch(batches, 3e-3)
    graphed.save_model_with_epoch(0)
    graphed.train_epoch(batches, 3e-3)
    first = graphed.graphs["train"]
    for executor in (graphed, eager):
        executor.load_model_with_epoch(0)
        executor.dropout_generator.manual_seed(7)
    assert graphed.graphs == {}
    assert graphed.train_epoch(batches, 3e-3) == _eager_epoch(eager, batches, 3e-3)
    assert graphed.graphs["train"] is not first and graphed.graphs["train"].replays == len(batches)
    _assert_same_state(graphed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_cuda_graphed_validation_and_predict_equal_eager(cuda, tmp_path, mode):
    (graphed,), (_, val, test) = _executors(tmp_path, mode, n=1)
    model = graphed.model
    with torch.no_grad():
        want_val = float(torch.stack([graphed.loss_fn(graphed.batch(val, idx), train=False)
                                      for idx in val.ordered_permutation()]).mean())
        want_pred = torch.cat([model(graphed.batch(test, idx)["X"])
                               for idx in test.ordered_permutation()]).float().cpu().numpy()
    for _ in range(2):  # the capture, then every batch replayed
        assert graphed._valid_epoch(val) == want_val
        assert np.array_equal(graphed.predict(test), want_pred)
    assert graphed.graphs["valid"].replays == 2 * len(val) - 1
    assert graphed.graphs["predict"].replays == 2 * len(test) - 1


def _services(tmp_path, mode):
    (executor,), (_, _, test) = _executors(tmp_path, mode, n=1)
    feature_scaler = executor._scaler
    graphed = PredictService(executor.model, feature_scaler, max_batch=16, device="cuda")
    eager = PredictService(executor.model, feature_scaler, max_batch=16, device="cuda")
    eager.graphed = False
    return graphed, eager, test.x[:16].cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_service_replies_equal_the_eager_model_bit_for_bit(cuda, tmp_path, mode):
    graphed, eager, x = _services(tmp_path, mode)
    assert graphed.graphed
    for batch in (1, 4, 16):
        want = eager.predict(x[:batch])
        for _ in range(2):  # the capture, then a replay
            assert np.array_equal(graphed.predict(x[:batch]), want)
    assert graphed.stats()["compiled_buckets"] == [1, 4, 16]
    assert all(graphed.graphs[b].replays == 1 for b in (1, 4, 16))


@pytest.mark.cuda
def test_cuda_short_request_after_a_full_bucket_equals_a_fresh_one(cuda, tmp_path):
    """A 3-row request replays bucket 4 after a 4-row one: its pad row is a
    copy of its own last row, never the earlier request's fourth."""
    graphed, eager, x = _services(tmp_path, "int8")
    graphed.predict(x[:4])
    got = graphed.predict(x[4:7])
    assert graphed.graphs[4].replays == 1
    fresh, _, _ = _services(tmp_path, "int8")
    assert np.array_equal(got, fresh.predict(x[4:7]))
    assert np.array_equal(got, eager.predict(x[4:7]))


@pytest.mark.cuda
def test_cuda_adagrad_trains_eagerly_and_validation_is_graphed(cuda, tmp_path):
    (graphed, eager), (train, val, _) = _executors(tmp_path, "int8", learner="adagrad")
    assert not graphed.graphs_train and graphed.graphs_forward
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    assert graphed.train_epoch(batches, 3e-3) == _eager_epoch(eager, batches, 3e-3)
    assert "train" not in graphed.graphs
    _assert_same_state(graphed, eager)
    assert graphed._valid_epoch(val) == graphed._valid_epoch(val)
    assert "valid" in graphed.graphs


# ---------------------------------------------------------------- SparseATGCN
# SYN_LARGE_TINY at 300 nodes (3 row blocks), hidden 8, 2 layers, T 4,
# batch 4, remat on, the adaptive view on every form (the defaults)
SPARSE_FORMS = {"bsr_adaptive": {}, "tail": {"graph_split": "tail"},
                "band_packed": {"graph_split": "band", "graph_band_packed": True}}
SPARSE_DTYPES = {"f32": None, "bf16": "bfloat16"}
SPARSE_CASES = [(form, dtype) for form in sorted(SPARSE_FORMS) for dtype in sorted(SPARSE_DTYPES)]
EAGER_RUNS = 5


def _sparse_executors(tmp_path, form, dtype, n=2):
    """`n` executors of the small SparseATGCN on the card, with the same
    weights and optimizer; and the data loaders."""
    args = {"output_dir": str(tmp_path / "out"), "exp_id": "sparse_graphs", "num_nodes": 300, "avg_degree": 8,
            "len_time": 60, "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8,
            "embed_dim_adj": 4, "num_layers": 2, "tensorboard": False, "learning_rate": 3e-3,
            "compute_dtype": SPARSE_DTYPES[dtype], **SPARSE_FORMS[form]}
    cfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY", other_args=args)
    ds = get_dataset(cfg)
    loaders = ds.get_data()
    feature = ds.get_data_feature()
    state = get_model(cfg, feature, generator=torch.Generator().manual_seed(0)).state_dict()
    executors = []
    for _ in range(n):
        model = get_model(cfg, feature)
        model.load_state_dict(state)
        executors.append(get_executor(cfg, model, feature))
    model = executors[0].model
    assert model.remat and model.has_adaptive and model.graph_safe
    assert ("tail_w" in model._support(0)) == (form == "tail")
    assert ("band_packed" in model._support(0)) == (form == "band_packed")
    return executors, loaders


def _train_state(executor):
    """Copies of the parameters and the optimizer's state tensors, by group."""
    params, state = list(executor.model.parameters()), executor.optimizer.state
    return {"params": [p.detach().clone() for p in params],
            "adam": [v.detach().clone() for p in params for _, v in sorted(state.get(p, {}).items())
                     if isinstance(v, torch.Tensor)]}


def _gaps(a, b):
    """{group: the largest |a - b| over its tensors, arrays or floats}."""
    def gap(x, y):
        if isinstance(x, torch.Tensor):
            return float((x.float() - y.float()).abs().max())
        return float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
    return {group: max(gap(x, y) for x, y in zip(a[group], b[group])) for group in a}


def _assert_held(replay, runs):
    """The replay against the first of the eager runs from the same state:
    bit for bit in every group where the eager runs agree bit for bit, else
    within 2x the largest gap between two of them (the atomic sums of the
    tail's index_add_ and index_select's backward change from run to run)."""
    eager = {group: 0.0 for group in replay}
    for i, a in enumerate(runs):
        for b in runs[i + 1:]:
            eager = {g: max(v, _gaps(a, b)[g]) for g, v in eager.items()}
    got = _gaps(replay, runs[0])
    assert all(got[g] <= 2.0 * eager[g] for g in got), (got, eager)


def _eager_runs(tmp_path, form, dtype, batches, lr=3e-3):
    """EAGER_RUNS eager epochs over `batches`, each from the same weights
    and optimizer in an executor of its own: their losses and states."""
    executors, _ = _sparse_executors(tmp_path, form, dtype, n=EAGER_RUNS)
    return [dict(loss=[_eager_epoch(ex, batches, lr)], **_train_state(ex)) for ex in executors]


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", SPARSE_CASES)
def test_cuda_sparse_replayed_steps_hold_to_eager_steps(cuda, tmp_path, form, dtype):
    (graphed,), (train, _, _) = _sparse_executors(tmp_path, form, dtype, n=1)
    assert graphed.graphs_train
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    got = graphed.train_epoch(batches, 3e-3)
    graph = graphed.graphs["train"]
    assert graph.replays == REPLAYS
    _assert_held(dict(loss=[got], **_train_state(graphed)), _eager_runs(tmp_path, form, dtype, batches))
    # every sparse wrapper the step launches is recorded, B4/B6 and B5 on
    # the BSR part and the adaptive view, B8 and B9 dX on the packed band
    captured = graph.captured
    prefix = "bf16_launches" if dtype == "bf16" else "launches"
    assert captured["spmm.bsr_spmm." + prefix] > 0 and captured["spmm.sampled_matmul." + prefix] > 0
    if form == "band_packed":
        assert captured["band.band_spmm_packed.launches"] > 0 and captured["band.band_dx_packed.launches"] > 0
    assert graph.replayed_launches() == {k: REPLAYS * v for k, v in captured.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", SPARSE_CASES)
def test_cuda_sparse_graphed_validation_and_predict_hold_to_eager(cuda, tmp_path, form, dtype):
    (graphed,), (_, val, test) = _sparse_executors(tmp_path, form, dtype, n=1)
    model = graphed.model
    with torch.no_grad():
        eager_val = [{"loss": [float(torch.stack([graphed.loss_fn(graphed.batch(val, idx), train=False)
                                                  for idx in val.ordered_permutation()]).mean())]}
                     for _ in range(EAGER_RUNS)]
        eager_pred = [{"pred": [torch.cat([model(graphed.batch(test, idx)["X"])
                                           for idx in test.ordered_permutation()]).float().cpu().numpy()]}
                      for _ in range(EAGER_RUNS)]
    for _ in range(2):  # the capture, then every batch replayed
        _assert_held({"loss": [graphed._valid_epoch(val)]}, eager_val)
        _assert_held({"pred": [graphed.predict(test)]}, eager_pred)
    assert graphed.graphs["valid"].replays == 2 * len(val) - 1
    assert graphed.graphs["predict"].replays == 2 * len(test) - 1


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", SPARSE_CASES)
def test_cuda_sparse_replay_after_load_model_with_epoch_is_recaptured(cuda, tmp_path, form, dtype):
    (graphed,), (train, _, _) = _sparse_executors(tmp_path, form, dtype, n=1)
    batches = _First(train, GRAPH_WARMUP_STEPS + REPLAYS)
    graphed.train_epoch(batches, 3e-3)
    graphed.save_model_with_epoch(0)
    graphed.train_epoch(batches, 3e-3)
    first = graphed.graphs["train"]
    graphed.load_model_with_epoch(0)
    assert graphed.graphs == {}
    got = graphed.train_epoch(batches, 3e-3)
    assert graphed.graphs["train"] is not first and graphed.graphs["train"].replays == len(batches)
    runs = []
    for ex in _sparse_executors(tmp_path, form, dtype, n=EAGER_RUNS)[0]:
        ex.load_model_with_epoch(0)
        runs.append(dict(loss=[_eager_epoch(ex, batches, 3e-3)], **_train_state(ex)))
    _assert_held(dict(loss=[got], **_train_state(graphed)), runs)


@pytest.mark.cuda
@pytest.mark.parametrize("form,dtype", SPARSE_CASES)
def test_cuda_sparse_service_replies_hold_to_the_eager_model(cuda, tmp_path, form, dtype):
    """PredictService's bucket graphs for SparseATGCN: each bucket's first
    request runs eagerly and captures, later ones replay; every reply holds
    to the eager model's (the padded batch through the model, the scaler's
    inverse, clipped at 0) by the rule of _assert_held."""
    (executor,), (_, _, test) = _sparse_executors(tmp_path, form, dtype, n=1)
    model, scaler = executor.model, executor._scaler
    service = PredictService(model, scaler, max_batch=4)
    assert service.graphed
    x = test.x[:4].cpu().numpy()
    for batch in (1, 3, 4):
        padded = torch.cat([test.x[:batch], test.x[batch - 1:batch].expand(4 - batch, -1, -1, -1)]) \
            if batch == 3 else test.x[:batch]
        with torch.no_grad():
            want = [{"reply": [np.maximum(scaler.inverse_transform(model(padded))[:batch].float().cpu().numpy(),
                                          0.0)]} for _ in range(EAGER_RUNS)]
        for _ in range(2):  # the capture (or a replay of bucket 4), then a replay
            _assert_held({"reply": [service.predict(x[:batch])]}, want)
    assert service.stats()["compiled_buckets"] == [1, 4]
    assert service.graphs[1].replays == 1 and service.graphs[4].replays == 3


_CAPTURE_SGD_TENSOR_RATE = """
import torch
p = torch.nn.Parameter(torch.randn(64, 64, device="cuda"))
opt = torch.optim.SGD([p], lr=torch.tensor(1e-3, device="cuda"))
x = torch.randn(8, 64, device="cuda")

def step():
    opt.zero_grad(set_to_none=True)
    (x @ p).square().mean().backward()
    opt.step()

side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    step()
torch.cuda.current_stream().wait_stream(side)
with torch.cuda.graph(torch.cuda.CUDAGraph()):
    step()
"""


@pytest.mark.cuda
def test_cuda_sgd_with_a_device_rate_fails_to_capture(cuda):
    """Why capture_rule gives SGD a float rate (and a re-capture when it
    changes): its torch step reads a device rate on the host, and the
    capture fails. It runs in a process of its own: a failed capture
    leaves the process's generators unusable."""
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-c", _CAPTURE_SGD_TENSOR_RATE], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0, run.stdout
    assert "capture" in run.stderr.lower(), run.stderr[-2000:]


@pytest.mark.cuda
def test_cuda_adagrad_replays_do_not_advance_its_step_count(cuda):
    """Why capture_rule keeps Adagrad eager: its step count is a CPU tensor
    that its step advances on the host, so a capture advances it once and
    no replay does; its state would drift from an eager run's."""
    p = torch.nn.Parameter(torch.randn(64, 64, device=cuda))
    opt = torch.optim.Adagrad([p], lr=1e-3)
    x = torch.randn(8, 64, device=cuda)

    def step():
        opt.zero_grad(set_to_none=True)
        (x @ p).square().mean().backward()
        opt.step()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    count = opt.state[p]["step"]
    assert count.device.type == "cpu"
    assert float(count) == 2.0  # the warm-up and the capture; eager: 1 + REPLAYS
