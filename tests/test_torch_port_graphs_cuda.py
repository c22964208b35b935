"""The executor's and the service's CUDA graphs on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. The file imports no
JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_graphs_cuda.py
The small MultiATGCN of test_torch_port_training_cuda.py (12 nodes, hidden
16, 2 layers, 24 steps, batch 8) with dropout on. A graphed run and an
eager one start from the same weights, optimizer and dropout generator
state, and must agree bit for bit: the losses, every parameter and the
optimizer's state after the replays, the validation loss and predictions,
and the service's replies. SparseATGCN is served eagerly.
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


@pytest.mark.cuda
def test_cuda_sparse_atgcn_is_served_eagerly(cuda, tmp_path):
    args = {"output_dir": str(tmp_path / "out"), "exp_id": "cuda", "num_nodes": 200, "avg_degree": 8,
            "len_time": 48, "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8,
            "embed_dim_adj": 4, "num_layers": 2, "tensorboard": False}
    cfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY", other_args=args)
    ds = get_dataset(cfg)
    _, _, test = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature)
    service = PredictService(model, feature["scaler"], max_batch=4)
    assert not service.graphed
    x = test.x[:3].cpu().numpy()
    got = service.predict(x)
    with torch.no_grad():
        padded = torch.cat([test.x[:3], test.x[2:3]])
        want = feature["scaler"].inverse_transform(model(padded))[:3].float().cpu().numpy()
    assert np.array_equal(got, np.maximum(want, 0.0))
    assert service.graphs == {} and service.stats()["compiled_buckets"] == [4]


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
