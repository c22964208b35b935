"""The port's SparseATGCN on the band, hub and tail graph forms against the
JAX package's, and the band form through the port's entry points.

Model parity: the forward and one loss's gradient for every parameter,
from the same seeded random weights (drawn in the JAX model's parameter
shapes and carried over with utils/jax_import.py, which loads the JAX
band, hub and tail models' parameters strictly both ways) on the same
numpy-seeded inputs; 1 layer, hidden 8, T 4, on 640 padded nodes (5
row blocks). The band graph holds diagonals -3..2 (so its packed rows have
an absent slot), a hub column and a COO tail, so the band support
exercises every part. Cases:
  * band planes, with the adaptive view (sampled softmax) and remat;
  * band packed (``graph_band_packed``), the same configuration;
  both held against one JAX run without remat on the planes (shared by
  the module-scoped fixture; the JAX package holds its packed form and its
  remat equal to that in tests/test_sparse_model.py);
  * hub (HybridGraph) with the adaptive view on the BSR remainder;
  * tail (TailGraph) with factored node conditioning.
JAX's band path runs on its default einsum dispatch; its BSR kernels run in
interpret mode. Tolerance: the relative max error (max |port - JAX| over
max |JAX|) of the output and of each gradient below 1e-5; both sides are
f32 and sum in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.models.sparse_atgcn import build_sparse_atgcn as jax_build
from multistgraph_tpu.ops import band as jax_band
from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu_torch import run_model as run_model_cli
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import band, bsr
from multistgraph_tpu_torch.serving import PredictService
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

NODES, B, T = 600, 2, 4
BOUND = 1e-5

CASES = {  # id -> (graph form, config overrides)
    "band_planes": ("band", {"adpadj": "unidirection", "adaptive_softmax": "sampled", "remat": True}),
    "band_packed": ("band", {"adpadj": "unidirection", "adaptive_softmax": "sampled", "remat": True,
                             "graph_band_packed": True}),
    "hub": ("hub", {"adpadj": "unidirection", "adaptive_softmax": "sampled"}),
    "tail": ("tail", {"node_conditioned": "factored"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**overrides):
    cfg = {"output_window": 3, "output_dim": 1, "rnn_units": 8, "num_layers": 1, "embed_dim_adj": 4,
           "adpadj": "none", "node_conditioned": "off", "embed_dim_node": 4, "remat": False}
    cfg.update(overrides)
    return cfg


def _band_edges():
    """A band of locality 200 over 5 row blocks; three popular columns, whose
    far edges fill diagonal -3 and leave one hub column in the rest; and
    scattered far edges that no diagonal keeps and no hub takes (the tail)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, NODES, 4000)
    dst = np.clip(src + rng.integers(-200, 201, 4000), 0, NODES - 1)
    hub_src = rng.integers(0, NODES, 300)
    hub_dst = rng.choice([17, 290, 555], 300)
    far_src, far_dst = np.array([3, 40, 590, 520]), np.array([560, 130, 10, 205])
    w = rng.uniform(0.1, 1.0, 4304).astype(np.float32)
    return np.concatenate([src, hub_src, far_src]), np.concatenate([dst, hub_dst, far_dst]), w


def _graphs(form):
    """The same graph in the port's and the JAX package's types."""
    if form == "band":
        edges = _band_edges()
        return (band.split_band(*edges, NODES, 128, min_fill_frac=0.5),
                jax_band.split_band(*edges, NODES, 128, min_fill_frac=0.5))
    return (bsr.random_spatial_graph(NODES, 8, seed=2, split=form)[0],
            jax_bsr.random_spatial_graph(NODES, 8, seed=2, split=form)[0])


def _random_variables(jmodel, x):
    """Seeded random weights of the JAX model's parameter shapes (no init
    program to compile) with its graph attached."""
    shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(7)
    params = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
    return jmodel.attach_graph({"params": params})


# options the JAX reference runs without: the packed storage gives the same
# operator as the planes, and remat the same numbers as the plain recurrence
# (tests/test_sparse_model.py::test_band_packed_support_matches_unpacked and
# ::test_remat_matches_plain), so the port's packed and remat paths are held
# against one plain JAX program, which compiles in a third of the time
PORT_ONLY = ("graph_band_packed", "remat")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX output and gradients per (form, config), computed once: the band
    planes' run serves the packed case too."""
    cache = {}

    def run(form, overrides, x, cot):
        jax_overrides = {k: v for k, v in overrides.items() if k not in PORT_ONLY}
        key = (form, tuple(sorted(jax_overrides.items())))
        if key not in cache:
            cfg = _config(**jax_overrides)
            jmodel = jax_build(_graphs(form)[1], cfg, interpret=True)
            variables = _random_variables(jmodel, x)

            def jloss(p):
                out = jmodel.apply({**variables, "params": p}, jnp.asarray(x), train=False)
                return jnp.sum(out * cot), out

            (_, out), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
            cache[key] = ({k: np.asarray(v) for k, v in variables["params"].items()}, np.asarray(out),
                          {k: np.asarray(v) for k, v in grads.items()})
        return cache[key]

    return run


def _rel(got, want):
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case, jax_runs):
    form, overrides = CASES[case]
    rng = np.random.default_rng(1)
    n_pad = -(-NODES // 128) * 128
    x = rng.normal(size=(B, T, n_pad, 1)).astype(np.float32)
    cot = rng.normal(size=(B, 3, n_pad, 1)).astype(np.float32)
    params, want, grads = jax_runs(form, overrides, x, cot)

    graph = _graphs(form)[0]
    model = build_sparse_atgcn(graph, _config(**overrides), device="cpu")
    buffers = {n for n, _ in model.named_buffers()}
    if form == "band":
        assert {"support0_hub_values", "support0_tail_w"} <= buffers  # every part of the band support
        assert ("support0_band_packed" in buffers) == ("graph_band_packed" in overrides)
    model.load_state_dict(state_dict_from_jax(params, model))
    out = model(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(cot)).sum().backward()

    assert out.shape == (B, 3, n_pad, 1)
    errs = {"output": _rel(out, want)}
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        assert named[name].grad is not None, name
        errs[name] = _rel(named[name].grad, g)
    worst = max(errs, key=errs.get)
    assert errs[worst] < BOUND, (worst, errs)


def test_band_adaptive_pattern_and_packed_support_equal_jax():
    """The adaptive view samples the band's tiles in row-major order, and the
    packed support holds JAX's packed rows, its radius and offsets."""
    graph, jgraph = _graphs("band")
    cfg = _config(adpadj="unidirection", graph_band_packed=True)
    model = build_sparse_atgcn(graph, cfg, device="cpu")
    jmodel = jax_build(jgraph, cfg)
    want_row, want_col = jmodel.adaptive_pattern
    np.testing.assert_array_equal(model.adaptive_row.numpy(), np.asarray(want_row))
    np.testing.assert_array_equal(model.adaptive_col.numpy(), np.asarray(want_col))
    (jsupport,) = jmodel.supports
    np.testing.assert_array_equal(model.support0_band_packed.numpy(), np.asarray(jsupport["band_packed"]))
    assert model._support_static[0]["band_radius_static"] == jsupport["band_radius_static"] == 3
    np.testing.assert_array_equal(model._support_static[0]["band_offsets_static"], jsupport["band_offsets_static"])


def test_run_model_trains_the_band_form_reloads_it_and_serves_it_packed(tmp_path):
    """run_model --graph_split band trains on band planes and reuses the .pt;
    from_experiment serves the same .pt from packed rows (no checkpoint
    migration: the graph is not in it) with the planes' predictions. Planes
    and packed rows sum the same products in other orders: rtol 1e-5 with
    atol 1e-5 times the largest prediction."""
    argv = ["--model", "SparseATGCN", "--dataset", "SYN_LARGE_BAND", "--exp_id", "band",
            "--output_dir", str(tmp_path / "out"), "--num_nodes", "300", "--avg_degree", "8",
            "--len_time", "48", "--input_window", "4", "--output_window", "2", "--rnn_units", "4",
            "--embed_dim_adj", "3", "--num_layers", "1", "--batch_size", "4", "--graph_split", "band",
            "--config_file", "cfg"]
    (tmp_path / "cfg.json").write_text('{"max_epoch": 1, "tensorboard": false}')
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        (trained,) = run_model_cli.main(argv + ["--device", "cpu"])
        (reused,) = run_model_cli.main(argv + ["--train", "false", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    for metric, values in trained.items():
        assert metric == "MAPE" or np.isfinite(values).all(), metric
        np.testing.assert_array_equal(reused[metric], values)

    args = {"output_dir": str(tmp_path / "out"), "exp_id": "band", "num_nodes": 300, "avg_degree": 8,
            "len_time": 48, "input_window": 4, "output_window": 2, "rnn_units": 4, "embed_dim_adj": 3,
            "num_layers": 1, "graph_split": "band"}
    served = {}
    for packed in (False, True):
        service = PredictService.from_experiment("traffic_state_pred", "SparseATGCN", "SYN_LARGE_BAND",
                                                 other_args=dict(args, graph_band_packed=packed), max_batch=4,
                                                 device="cpu")
        names = {n for n, _ in service.model.named_buffers()}
        assert ("support0_band_packed" in names, "support0_band_values" in names) == (packed, not packed)
        x = np.random.default_rng(3).normal(size=(3, 4, 384, 1)).astype(np.float32)
        served[packed] = service.predict(x)
    assert served[True].shape == (3, 2, 384, 1) and np.isfinite(served[True]).all()
    np.testing.assert_allclose(served[True], served[False], rtol=1e-5, atol=1e-5 * np.abs(served[False]).max())
