"""The model zoo's last six families (MTGNN, STSGCN, STTN, GMAN, STGODE,
STGNCDE) and node2vec against the JAX package.

Each case builds a family through both registries at the JAX zoo tests'
tiny shapes (B=4, Tin=12, Tout=3, N=5, F=2), carries the JAX weights
over by ``state_dict_from_jax``, and holds the forward and every
parameter's gradient of mean(out * w) to atol 1e-5, rtol 1e-4
(test_torch_port_zoo.py's limits), the JAX references jitted: MTGNN at
Tin=12 (front-padded to its receptive field) and 24, STSGCN's two module
types, GMAN with and without the time-of-day channel and with node2vec's
spatial embedding, STGODE's spectral and RK4 solvers, STGNCDE's linear and
cubic controls and its bf16 field (held to BOUND_BF16). The host helpers
are held bit for bit, and STGNCDE and MTGNN (dropout 0) train through the
port's executor against the JAX executor (losses rtol 2e-5, metrics 1e-3).
Nothing here needs the card; chip_smoke.py's zoo_phase runs these families
there.
"""

import csv
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.config import load_config as jax_load_config
from multistgraph_tpu.data import get_dataset as jax_get_dataset
from multistgraph_tpu.executor import get_executor as jax_get_executor
from multistgraph_tpu.graph import node2vec as jax_node2vec
from multistgraph_tpu.models import gman as jax_gman
from multistgraph_tpu.models import stgncde as jax_stgncde
from multistgraph_tpu.models import stgode as jax_stgode
from multistgraph_tpu.models import stsgcn as jax_stsgcn
from multistgraph_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from multistgraph_tpu_torch.config import load_config
from multistgraph_tpu_torch.data import get_dataset
from multistgraph_tpu_torch.data.synthetic import make_synthetic_dataset
from multistgraph_tpu_torch.executor import get_executor
from multistgraph_tpu_torch.graph import node2vec
from multistgraph_tpu_torch.models import MODEL_REGISTRY, gman, stgncde, stgode, stsgcn
from multistgraph_tpu_torch.utils.jax_import import state_dict_from_jax

TASK = "traffic_state_pred"
B, TIN, TOUT, N, F = 4, 12, 3, 5, 2
ATOL, RTOL = 1e-5, 1e-4
# STGNCDE's bf16 field against JAX's, relative to the largest |value|.
# Both round the same operands to bf16 and sum their products in f32, but
# JAX's gradient of the bf16 pool accumulates over the RK4 stages in its
# own order and precision: at these shapes JAX's bf16 form sits 1.26e-3
# (output) and at most 1.31e-2 (gradients, g1_bias; g_pool 9.7e-3) off its
# own f32 form, the port's bf16 1.26e-3 and 3.6e-3 off the port's f32. The
# bound is twice JAX's own gaps, the triangle bound for a port whose bf16
# is no farther from f32 than JAX's; the port reads 1.8e-7 (output) and
# 1.1e-2 (g_pool) off JAX's bf16.
BOUND_BF16 = {"out": 2.5e-3, "grad": 2.6e-2}

# each case: (family, config at the tiny shapes, input window)
CASES = {
    "MTGNN": ("MTGNN", {"embed_dim_node": 4, "subgraph_size": 3, "conv_channels": 8, "residual_channels": 8,
                        "skip_channels": 8, "end_channels": 16, "layers": 2, "gcn_depth": 2}, TIN),
    "MTGNN-tin24": ("MTGNN", {"embed_dim_node": 4, "subgraph_size": 3, "conv_channels": 8, "residual_channels": 8,
                              "skip_channels": 8, "end_channels": 16, "layers": 2, "gcn_depth": 2}, 24),
    "STSGCN": ("STSGCN", {"rnn_units": 8, "gcn_depth": 2, "num_layers": 2, "module_type": "individual"}, TIN),
    "STSGCN-sharing": ("STSGCN", {"rnn_units": 8, "gcn_depth": 2, "num_layers": 2, "module_type": "sharing"}, TIN),
    "STTN": ("STTN", {"rnn_units": 8, "num_heads": 2, "num_blocks": 2, "ffn_dim": 16}, TIN),
    "GMAN": ("GMAN", {"num_heads": 2, "head_dim": 4, "num_blocks": 1, "se_dim": 3, "add_time_in_day": True}, TIN),
    "GMAN-no-time": ("GMAN", {"num_heads": 2, "head_dim": 4, "num_blocks": 1, "se_dim": 3}, TIN),
    "GMAN-node2vec": ("GMAN", {"num_heads": 2, "head_dim": 4, "num_blocks": 1, "se_dim": 3, "add_time_in_day": True,
                               "gman_se": "node2vec", "n2v_walks": 3, "n2v_length": 8, "n2v_window": 3}, TIN),
    "STGODE": ("STGODE", {"rnn_units": 8, "stgode_blocks": 2, "ode_steps": 3, "stgode_head_dim": 16,
                          "stgode_dtw_band": 3, "stgode_sparsity": 0.3}, TIN),
    "STGODE-rk4": ("STGODE", {"rnn_units": 8, "stgode_blocks": 2, "ode_steps": 3, "stgode_head_dim": 16,
                              "stgode_dtw_band": 3, "stgode_sparsity": 0.3, "stgode_solver": "rk4"}, TIN),
    "STGNCDE": ("STGNCDE", {"rnn_units": 8, "ncde_field_dim": 8, "embed_dim_node": 4, "cheb_order": 3,
                            "ncde_substeps": 2}, TIN),
    "STGNCDE-cubic": ("STGNCDE", {"rnn_units": 8, "ncde_field_dim": 8, "embed_dim_node": 4, "cheb_order": 3,
                                  "ncde_substeps": 2, "ncde_control": "cubic"}, TIN),
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
    profiles = np.random.default_rng(2).normal(size=(N, 8)).astype(np.float32)
    return {"num_nodes": N, "feature_dim": F, "output_dim": 1, "adj_mx": _adj(), "node_profiles": profiles}


def _config(case, **extra):
    _family, config, tin = CASES[case]
    return dict(config, input_window=tin, output_window=TOUT, seed=0, **extra)


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


def _torch_name(jax_name):
    """utils/jax_import.py's rule: a flax LayerNorm's ``l0_ln/scale`` is ``l0_ln.weight``."""
    if "/" not in jax_name:
        return jax_name
    module, leaf = jax_name.rsplit("/", 1)
    return module + "." + {"scale": "weight"}.get(leaf, leaf)


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    family, _config_, tin = CASES[case]
    jmodel = JAX_REGISTRY[family](_config(case), _feature())
    x = jnp.zeros((B, tin, N, F), jnp.float32)
    return jax.jit(lambda k: jmodel.init(k, x))(jax.random.PRNGKey(0))


def _pair(case, **extra):
    """(JAX module, its params, a port module carrying them)."""
    family = CASES[case][0]
    params = _jax_params(case)
    jmodel = JAX_REGISTRY[family](_config(case, **extra), _feature())
    model = MODEL_REGISTRY[family](_config(case, **extra), _feature(), device="cpu")
    model.load_state_dict(state_dict_from_jax(_flat(params["params"]), model))
    return jmodel, params, model


def _inputs(tin, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, tin, N, F)).astype(np.float32)
    w = rng.normal(size=(B, TOUT, N, 1)).astype(np.float32)
    return x, w


def _runs(jmodel, params, model, tin):
    """The JAX and the port's output and gradients of mean(out * w), as numpy."""
    x, w = _inputs(tin)

    def loss(p):
        out = jmodel.apply({**params, "params": p}, jnp.asarray(x))
        return jnp.mean(out * w), out

    (_, want_out), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["params"])
    out = model(torch.from_numpy(x))
    (out * torch.from_numpy(w)).mean().backward()
    named = dict(model.named_parameters())
    want = _flat(want_grads)
    assert len(want) == len(named)
    got = {j: named[_torch_name(j)].grad.numpy() for j in want}
    return (out.detach().numpy(), got), (np.asarray(want_out), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(case):
    jmodel, params, model = _pair(case)
    (out, grads), (want_out, want_grads) = _runs(jmodel, params, model, CASES[case][2])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=RTOL)
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name], g, atol=ATOL, rtol=RTOL, err_msg=name)


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_stgncde_bf16_field_matches_jax_within_its_bound():
    jmodel, params, model = _pair("STGNCDE", compute_dtype="bfloat16")
    assert model.cdtype == torch.bfloat16
    (out, grads), (want_out, want_grads) = _runs(jmodel, params, model, TIN)
    assert out.dtype == np.float32
    assert _rel(out, want_out) <= BOUND_BF16["out"]
    for name, g in want_grads.items():
        if np.abs(g).max() > 0:
            assert _rel(grads[name], g) <= BOUND_BF16["grad"], name


def test_mtgnn_keeps_ties_and_takes_no_gradient_through_dropped_entries():
    from multistgraph_tpu.models.mtgnn import learned_adjacency as jax_learned
    from multistgraph_tpu_torch.models.mtgnn import learned_adjacency

    rng = np.random.default_rng(4)
    e1, e2 = rng.normal(size=(2, 7, 3)).astype(np.float32)
    w1, w2 = rng.normal(size=(2, 3, 3)).astype(np.float32)
    args = [torch.tensor(a, requires_grad=True) for a in (e1, e2, w1, w2)]
    a = learned_adjacency(*args, 3.0, 3)
    want = np.asarray(jax.jit(lambda *p: jax_learned(*p, 3.0, 3))(e1, e2, w1, w2))
    np.testing.assert_allclose(a.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    assert ((a > 0).sum(dim=1) <= 3).all()
    # a row of equal values keeps them all
    tied = torch.ones(2, 5)
    kth = torch.topk(tied, 2).values[:, -1:]
    assert torch.equal(torch.where(tied >= kth, tied, torch.zeros_like(tied)), tied)
    grads = torch.autograd.grad(a.sum(), args)
    want_grads = jax.jit(jax.grad(lambda *p: jax_learned(*p, 3.0, 3).sum(), argnums=(0, 1, 2, 3)))(e1, e2, w1, w2)
    for g, wg in zip(grads, want_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=ATOL, rtol=RTOL)


def test_host_helpers_are_bit_identical():
    adj = _adj(9, 3) * np.random.default_rng(3).random((9, 9)).astype(np.float32)
    adj[4] = 0.0   # a row of zero degree
    for steps in (2, 3):
        np.testing.assert_array_equal(stsgcn.build_sync_adjacency(adj, steps),
                                      jax_stsgcn.build_sync_adjacency(adj, steps))
    for dim in (3, 8, 12):   # 12: more than the graph's non-trivial eigenvectors, zero-padded
        np.testing.assert_array_equal(gman.laplacian_positional_embedding(adj, dim),
                                      jax_gman.laplacian_positional_embedding(adj, dim))
    for p, q in ((1.0, 1.0), (0.5, 2.0)):
        np.testing.assert_array_equal(node2vec.node2vec_walks(adj, 3, 9, p, q, seed=5),
                                      jax_node2vec.node2vec_walks(adj, 3, 9, p, q, seed=5))
    np.testing.assert_array_equal(node2vec.node2vec_embedding(adj, 4, num_walks=3, walk_length=9, window=3, seed=5),
                                  jax_node2vec.node2vec_embedding(adj, 4, num_walks=3, walk_length=9, window=3,
                                                                  seed=5))
    profiles = np.random.default_rng(6).normal(size=(9, 24)).astype(np.float32)
    for band in (2, 4, 30):
        dist = stgode.dtw_profile_distances(profiles, band)
        np.testing.assert_array_equal(dist, jax_stgode.dtw_profile_distances(profiles, band, native=False))
        for sparsity in (0.1, 0.5):
            np.testing.assert_array_equal(stgode.semantic_adjacency_from_dtw(dist, sparsity),
                                          jax_stgode.semantic_adjacency_from_dtw(dist, sparsity))
    np.testing.assert_array_equal(stgode._sym_norm_with_self_loops(adj), jax_stgode._sym_norm_with_self_loops(adj))
    # JAX's op-by-op arithmetic: jitted, XLA fuses the sweep's elementwise
    # ops and moves some results by an f32 ulp
    for t in (2, 3, 12):
        xx = np.random.default_rng(t).normal(size=(3, t, 4, 2)).astype(np.float32)
        got = stgncde.natural_cubic_coeffs(torch.from_numpy(xx))
        with jax.disable_jit():
            want = jax_stgncde.natural_cubic_coeffs(jnp.asarray(xx))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------- executor against JAX's

EXEC_DATASET = "SYN_ZOO_REST"
EXEC_MODELS = {
    "STGNCDE": {"rnn_units": 4, "ncde_field_dim": 4, "embed_dim_node": 3},
    "MTGNN": {"dropout": 0.0, "embed_dim_node": 3, "subgraph_size": 3, "conv_channels": 4, "residual_channels": 4,
              "skip_channels": 4, "end_channels": 8, "layers": 1},
}


def _exec_args(raw, out, name):
    return {"data_dir": raw, "cache_dir": os.path.join(out, "cache"), "output_dir": out, "exp_id": name,
            "cache_dataset": False, "max_epoch": 2, "train_rate": 0.7, "eval_rate": 0.15, "input_window": 6,
            "output_window": 3, "load_external": True, "load_dynamic": False, "add_time_in_day": True,
            "batch_size": 16, "seed": 0, "tensorboard": False, **EXEC_MODELS[name]}


def _losses(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r["train_loss"]), float(r["val_loss"])] for r in rows])


@pytest.mark.parametrize("name", sorted(EXEC_MODELS))
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
    executor.train(train, val)
    result = executor.evaluate(test)

    got, want = _losses(executor._metrics_log), _losses(jexec._metrics_log)
    assert got.shape == want.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5)
    for metric in result:
        np.testing.assert_allclose(result[metric], jresult[metric].to_numpy(), rtol=1e-3, err_msg=metric)
