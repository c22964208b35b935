"""SparseATGCN under the graph layer, on the CPU.

On the CPU nothing is captured (CUDA graphs need the card; their tests are
in test_torch_port_graphs_cuda.py). These tests hold the port's
bench_large_graph training step, which the card records as a CUDA graph,
to the JAX tool's jitted step (tools/bench_large_graph.py:184-202, written
out here as the tool writes it: optax.chain(clip_by_global_norm(5.0),
adam(1e-3)) on the L1 loss of model.apply(train=False)), from the same
weights (drawn in the JAX tree's shapes, carried over by
utils/jax_import.py) on the same numpy-seeded x and y: 3 steps on the
tool's synthetic graph at 512 nodes (4 row blocks), T 3, hidden 8, on the
BSR form with the adaptive view (the JAX Pallas kernels in interpret mode)
and on the band form. Losses and parameters at rtol 2e-5 (ROADMAP.md §C
item 14: the port's CPU Adam computes 1 - beta^t in f64 on the host, optax
in f32). They also check that SparseATGCN declares itself graph_safe and
that the executor and the service keep it eager on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multistgraph_tpu.models.sparse_atgcn import build_sparse_atgcn as jax_build
from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.models import get_model
from multistgraph_tpu_torch.models.sparse_atgcn import SparseATGCN, build_sparse_atgcn
from multistgraph_tpu_torch.serving import PredictService
from multistgraph_tpu_torch.tools import bench_large_graph
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

NODES, DEGREE, T, BATCH, HIDDEN, EMBED = 512, 8, 3, 2, 8, 4
STEPS = 3
RTOL = 2e-5
FORMS = {"bsr_adaptive": ["none"], "band": ["band", "--adpadj", "none"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cli(form):
    return bench_large_graph.parse_args([str(NODES), str(DEGREE), str(T), str(BATCH)] + FORMS[form] + [
        "--hidden", str(HIDDEN), "--embed-dim", str(EMBED), "--device", "cpu"])


def _jax_steps(cli, x, y):
    """The JAX tool's training step, jitted with params and optimizer state
    donated, `STEPS` times from seeded random weights; returns (the
    weights, the losses, the final params)."""
    graph, _ = jax_bsr.random_spatial_graph(cli.num_nodes, cli.avg_degree, seed=0,
                                            split=None if cli.split == "none" else cli.split)
    model = jax_build(graph, bench_large_graph.model_config(cli), interpret=True)
    shapes = jax.eval_shape(lambda k, xx: model.init(k, xx, train=False), jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(7)
    weights = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
    params = model.attach_graph({"params": {k: jnp.asarray(v) for k, v in weights.items()}})

    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    opt_state = tx.init(params["params"])

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, x, y):
        others = {k: v for k, v in params.items() if k != "params"}

        def loss_fn(trainable):
            pred = model.apply({"params": trainable, **others}, x, train=False)
            return jnp.mean(jnp.abs(pred - y))

        loss, grads = jax.value_and_grad(loss_fn)(params["params"])
        updates, opt_state = tx.update(grads, opt_state, params["params"])
        params = dict(params)
        params["params"] = optax.apply_updates(params["params"], updates)
        return params, opt_state, loss

    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    return weights, losses, {k: np.asarray(v) for k, v in params["params"].items()}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bench_large_graph_steps_match_the_jax_tools_jitted_step(form):
    cli = _cli(form)
    graph = bench_large_graph.build_graph(cli)
    model = build_sparse_atgcn(graph, bench_large_graph.model_config(cli), device="cpu")
    assert model.remat and model.has_adaptive == (form == "bsr_adaptive")
    x, y = bench_large_graph.inputs(cli, model.num_nodes, torch.device("cpu"))
    weights, want_losses, want_params = _jax_steps(cli, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    model.load_state_dict(state_dict_from_jax(weights, model))
    optimizer = bench_large_graph.make_optimizer(model, torch.device("cpu"))
    assert isinstance(optimizer, torch.optim.Adam) and not isinstance(optimizer.param_groups[0]["lr"], torch.Tensor)
    losses = [float(bench_large_graph.train_step(model, optimizer, x, y)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    got = state_dict_from_jax(want_params, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), got[name].numpy(), rtol=RTOL, atol=RTOL * float(
            got[name].abs().max()), err_msg=name)


def test_sparse_atgcn_is_graph_safe_and_runs_eagerly_on_the_cpu(tmp_path):
    assert SparseATGCN.graph_safe
    args = {"output_dir": str(tmp_path / "out"), "exp_id": "graphs", "num_nodes": 200, "avg_degree": 8,
            "len_time": 48, "input_window": 4, "output_window": 2, "batch_size": 4, "rnn_units": 8,
            "embed_dim_adj": 4, "num_layers": 2, "tensorboard": False}
    cfg = load_config("traffic_state_pred", "SparseATGCN", "SYN_LARGE_TINY", other_args=args)
    ds = get_dataset(cfg, device="cpu")
    train, val, test = ds.get_data()
    feature = ds.get_data_feature()
    model = get_model(cfg, feature, device="cpu")
    assert model.graph_safe
    executor = get_executor(cfg, model, feature, device="cpu")
    assert not executor.graphs_forward and not executor.graphs_train
    executor.train_epoch(train, 1e-3)
    executor._valid_epoch(val)
    executor.predict(test)
    assert executor.graphs == {}
    service = PredictService(model, feature["scaler"], max_batch=4, device="cpu")
    assert not service.graphed
    service.predict(test.x[:3].numpy())
    assert service.graphs == {} and service.stats()["compiled_buckets"] == [4]
