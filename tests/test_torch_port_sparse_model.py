"""The port's SparseATGCN against the JAX package's: the forward and one
loss's gradient for every parameter, from the same seeded random weights
(drawn in the JAX parameter tree's shapes, carried over with
utils/jax_import.py) on the same numpy-seeded inputs.

Two 128-node blocks (N_PAD 256), hidden 8, T 4, 2 layers, over a random
BSR graph; the JAX Pallas kernels run in interpret mode, as
tests/test_sparse_model.py runs them. Three configurations cover the
options: no adaptive view (shared pools, remat off); the adaptive view
with the 'sampled' softmax and remat on; the 'dense_corrected' softmax
with factored node conditioning and remat off. Tolerance: the relative max
error (max |port - JAX| over max |JAX|) of the output and of each gradient
below 1e-5. Both are f32; the sums run in other orders (the SpMM's
gathered bmm and index_add_ against the interpreter's per-block dots).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.models.sparse_atgcn import build_sparse_atgcn as jax_build
from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import bsr
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

N_PAD, B, T = 256, 2, 4
BOUND = 1e-5

CASES = {  # id -> config overrides
    "plain": {"adpadj": "none", "remat": False},
    "adaptive_sampled_remat": {"adpadj": "unidirection", "adaptive_softmax": "sampled", "remat": True},
    "factored_adaptive_dense_corrected": {"adpadj": "unidirection", "adaptive_softmax": "dense_corrected",
                                          "node_conditioned": "factored", "remat": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**overrides):
    cfg = {"output_window": 3, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "none", "node_conditioned": "off", "embed_dim_node": 4, "remat": False}
    cfg.update(overrides)
    return cfg


def _graph():
    rng = np.random.default_rng(0)
    dense = ((rng.uniform(size=(N_PAD, N_PAD)) < 0.05) * rng.uniform(0.1, 1.0, size=(N_PAD, N_PAD)))
    return dense.astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    cfg = _config(**CASES[case])
    dense = _graph()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, N_PAD, 1)).astype(np.float32)
    cot = rng.normal(size=(B, 3, N_PAD, 1)).astype(np.float32)

    jmodel = jax_build(jax_bsr.bsr_from_dense(dense), cfg, interpret=True)
    # seeded random weights in the parameter tree's shapes: no init program to compile
    shapes = jax.eval_shape(lambda k, xx: jmodel.init(k, xx, train=False), jax.random.PRNGKey(0), jnp.asarray(x))
    wrng = np.random.default_rng(7)
    params = {k: (wrng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in shapes["params"].items()}
    variables = jmodel.attach_graph({"params": params})

    def jloss(p):
        out = jmodel.apply({**variables, "params": p}, jnp.asarray(x), train=False)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    model = build_sparse_atgcn(bsr.bsr_from_dense(dense), cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax({k: np.asarray(v) for k, v in params.items()}, model))
    out = model(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(cot)).sum().backward()

    assert out.shape == (B, 3, N_PAD, 1)
    errs = {"output": _rel(out, want)}
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for name, g in grads.items():
        assert named[name].grad is not None, name
        errs[name] = _rel(named[name].grad, g)
    worst = max(errs, key=errs.get)
    assert errs[worst] < BOUND, (worst, errs)


def test_no_grad_forward_skips_the_transposes_and_matches():
    """Serving and validation run without autograd: no block transpose is
    formed, and the output is the same as with autograd."""
    cfg = _config(adpadj="unidirection", remat=True)
    model = build_sparse_atgcn(bsr.bsr_from_dense(_graph()), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, T, N_PAD, 1)).astype(np.float32))
    with torch.no_grad():
        assert model._precompute_transposes(None) == ([None], None)
        y = model(x)
    np.testing.assert_array_equal(y.numpy(), model(x).detach().numpy())


def test_graph_is_not_part_of_the_state_dict():
    model = build_sparse_atgcn(bsr.bsr_from_dense(_graph()), _config(adpadj="unidirection"), device="cpu")
    assert set(model.state_dict()) == {n for n, _ in model.named_parameters()}
    assert {"support0_values", "adaptive_row"} <= {n for n, _ in model.named_buffers()}


@pytest.mark.parametrize("option,match", [
    ({"node_parallel": True}, "ROADMAP.md A.7"),
])
def test_unported_options_raise(option, match):
    with pytest.raises(NotImplementedError, match=match):
        build_sparse_atgcn(bsr.bsr_from_dense(_graph()), _config(**option), device="cpu")


def test_graph_band_packed_builds_the_packed_rows_and_no_planes():
    """graph_band_packed stores a band graph's support as packed rows and
    no planes; on a plain BSR graph it changes nothing, as in the JAX
    builder."""
    from multistgraph_tpu_torch.ops.band import BandGraph

    band_graph = bsr.random_spatial_graph(1000, 16, seed=1, split="band")[0]
    assert isinstance(band_graph, BandGraph)
    names = {n for n, _ in build_sparse_atgcn(band_graph, _config(graph_band_packed=True),
                                              device="cpu").named_buffers()}
    assert "support0_band_packed" in names and "support0_band_values" not in names
    plain = build_sparse_atgcn(bsr.bsr_from_dense(_graph()), _config(graph_band_packed=True), device="cpu")
    assert {"support0_values", "support0_row_ptr"} <= {n for n, _ in plain.named_buffers()}


def test_adaptive_max_blocks_samples_the_blocks_jax_samples():
    """adaptive_max_blocks keeps the statically heaviest tiles in the adaptive
    view, as the JAX builder picks them."""
    graph = bsr.random_spatial_graph(1000, 16, seed=1)[0]
    cfg = _config(adpadj="unidirection", adaptive_max_blocks=20)
    model = build_sparse_atgcn(graph, cfg, device="cpu")
    want_row, want_col = jax_build(jax_bsr.random_spatial_graph(1000, 16, seed=1)[0], cfg).adaptive_pattern
    assert graph.nnz_blocks > 20 and model.adaptive_row.numel() == 20
    np.testing.assert_array_equal(model.adaptive_row.numpy(), np.asarray(want_row))
    np.testing.assert_array_equal(model.adaptive_col.numpy(), np.asarray(want_col))
