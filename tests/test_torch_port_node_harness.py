"""The node-apply harness slice of the port: B1, B1t, B11 A/B/D, B10, B12's stream rate.

On the CPU the wrappers take their plain versions, which are held against
the JAX package:
  * B1 ``node_factored_apply`` and B1t ``node_factored_apply_t`` against
    multistgraph_tpu/ops/node_apply.py's Pallas kernels in interpret mode at
    tests/test_node_apply.py's shapes (N=140: the JAX wrappers pad to 128
    nodes, the port masks the ragged edge), f32 and bf16, with the gate
    folded by ``pool_to_kernel_layout``. f32 results and B1's f32 output of
    bf16 operands: rtol 1e-5 with atol 1e-5 max|JAX| (the same f32 products
    summed in another order); B1t's bf16 output: within one bf16 step (the
    same bf16-rounded q, f32 sums in another order, which can move the
    final rounding by one step, 2^-7 of the value at most).
  * the adjoint identity <B1(hh), dpre> = <hh, B1t(dpre)>, rtol 1e-5;
  * B11 A, B and D against tools/bench_node_dots.py's make_a / make_b /
    make_d in interpret mode at reduced shapes (the tool is loaded by file
    path and its shape globals set; nothing in tools/ changes): A and B
    within one bf16 step (bf16 outputs of f32 sums in another order), D
    bit-identical (no reduction: the same two adds);
  * B10 (``column_sum_read``) and the stream rate (``stream_rate_read``)
    against their formulas (tools/bench_hbm_peak.py:146-153,
    tools/bench_stream_rate.py:40-46) computed in numpy, rtol 1e-6 for
    B10's column sums (f32 in another order), bit-identical for the stream
    rate; the checksums exactly.
Torch runs on one intra-op thread. The tests marked ``cuda`` hold each CUDA
kernel against its plain version on the card (B1, the harness's rows form
and B11 A at rtol 1e-5 with atol 1e-5 max|plain| or one bf16 step; B1t
likewise; the stream-read modes bit-identical, B10 rtol 1e-5 with atol
1e-5 max|plain|, every checksum exactly) and skip without one; they import
no JAX:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_node_harness.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.ops import node_apply, stream_read
from multistgraph_tpu_torch.ops.node_dots import node_dots, node_dots_plain
from multistgraph_tpu_torch.tools import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K, N, I, D, O = 2, 3, 140, 8, 4, 16   # tests/test_node_apply.py's shapes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32) * 0.3
    gate = np.exp(f(K))
    return dict(hh=f(B, K, N, I), e=f(N, D), pool=f(D, K, I, O), dpre=f(B, N, O),
                gate=(gate / gate.sum()).astype(np.float32))


def _bf16_np(a):
    """a rounded to bf16 (as torch rounds), returned as f32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def _assert_within_one_bf16_step(got, want):
    """|got - want| <= 2^-7 |want| + 2^-7 1e-3 max|want| elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0 ** -7 * np.abs(want) + 2.0 ** -7 * 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), float(np.abs(got - want).max())


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------- B1, B1t against JAX


@pytest.mark.parametrize("gated", [False, True])
def test_pool_to_kernel_layout_matches_jax_exactly(gated):
    import jax.numpy as jnp
    from multistgraph_tpu.ops.node_apply import pool_to_kernel_layout as jax_layout

    a = _arrays()
    gate = a["gate"] if gated else None
    want = jax_layout(jnp.asarray(a["pool"]), None if gate is None else jnp.asarray(gate))
    got = node_apply.pool_to_kernel_layout(torch.from_numpy(a["pool"]),
                                           None if gate is None else torch.from_numpy(gate))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_to_kernel_layout_passes_the_gradient():
    pool = torch.randn(D, K, I, O, requires_grad=True)
    mat, mat_t = node_apply.pool_to_kernel_layout(pool, torch.full((K,), 2.0))
    (mat.sum() + 3 * mat_t.sum()).backward()
    assert torch.equal(pool.grad, torch.full_like(pool, 8.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_factored_apply_matches_jax_interpret(dtype, gated):
    import jax.numpy as jnp
    from multistgraph_tpu.ops.node_apply import node_factored_apply as jax_apply
    from multistgraph_tpu.ops.node_apply import pool_to_kernel_layout as jax_layout

    a = _arrays(1)
    gate = jnp.asarray(a["gate"]) if gated else None
    mat_j, _ = jax_layout(jnp.asarray(a["pool"]), gate)
    hh_j = jnp.asarray(a["hh"]).astype(dtype)
    want = jax_apply(hh_j, jnp.asarray(a["e"]), mat_j.astype(dtype), interpret=True)
    assert want.dtype == jnp.float32
    tdt = getattr(torch, dtype)
    mat, _ = node_apply.pool_to_kernel_layout(torch.from_numpy(a["pool"]),
                                              torch.from_numpy(a["gate"]) if gated else None)
    got = node_apply.node_factored_apply(torch.from_numpy(a["hh"]).to(tdt), torch.from_numpy(a["e"]),
                                         mat.to(tdt))
    assert got.dtype == torch.float32 and got.shape == (B, N, O)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_factored_apply_t_matches_jax_interpret(dtype, gated):
    import jax.numpy as jnp
    from multistgraph_tpu.ops.node_apply import node_factored_apply_t as jax_apply_t
    from multistgraph_tpu.ops.node_apply import pool_to_kernel_layout as jax_layout

    a = _arrays(2)
    gate = jnp.asarray(a["gate"]) if gated else None
    _, mat_t_j = jax_layout(jnp.asarray(a["pool"]), gate)
    dpre_j = jnp.asarray(a["dpre"]).astype(dtype)
    want = jax_apply_t(dpre_j, jnp.asarray(a["e"]), mat_t_j.astype(dtype), interpret=True)
    tdt = getattr(torch, dtype)
    _, mat_t = node_apply.pool_to_kernel_layout(torch.from_numpy(a["pool"]),
                                                torch.from_numpy(a["gate"]) if gated else None)
    got = node_apply.node_factored_apply_t(torch.from_numpy(a["dpre"]).to(tdt), torch.from_numpy(a["e"]),
                                           mat_t.to(tdt))
    assert got.dtype == tdt and got.shape == (B, K, N, I)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got.numpy(), want)
    else:
        _assert_within_one_bf16_step(got.float().numpy(), want)


def test_factored_apply_t_f32_out_of_bf16_operands_matches_jax():
    """bf16 operands, an f32 result: q still rounds to bf16. JAX's jitted
    wrapper cannot take a dtype for out_dtype (the argument is not static),
    so the port's f32 result is held within one bf16 step of JAX's bf16 one."""
    import jax.numpy as jnp
    from multistgraph_tpu.ops.node_apply import node_factored_apply_t as jax_apply_t

    a = _arrays(3)
    _, mat_t = node_apply.pool_to_kernel_layout(torch.from_numpy(a["pool"]))
    want = jax_apply_t(jnp.asarray(a["dpre"]).astype(jnp.bfloat16), jnp.asarray(a["e"]),
                       jnp.asarray(mat_t.numpy()).astype(jnp.bfloat16), interpret=True)
    got = node_apply.node_factored_apply_t(torch.from_numpy(a["dpre"]).to(torch.bfloat16),
                                           torch.from_numpy(a["e"]), mat_t.to(torch.bfloat16),
                                           out_dtype=torch.float32)
    assert got.dtype == torch.float32
    _assert_within_one_bf16_step(np.asarray(want.astype(jnp.float32)), got.numpy())


def test_factored_pair_is_adjoint():
    """<B1(hh), dpre> = <hh, B1t(dpre)>: B1t is B1's transpose."""
    a = _arrays(4)
    hh, e, dpre = (torch.from_numpy(a[k]) for k in ("hh", "e", "dpre"))
    mat, mat_t = node_apply.pool_to_kernel_layout(torch.from_numpy(a["pool"]))
    lhs = (node_apply.node_factored_apply(hh, e, mat).double() * dpre.double()).sum().item()
    rhs = (hh.double() * node_apply.node_factored_apply_t(dpre, e, mat_t).double()).sum().item()
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


# ---------------------------------------------------------------- B11 against the JAX harness

SMALL = dict(T=3, B=4, NP=64, KI=24, O=16, D=3, BLK=32, RB=64)


@pytest.fixture(scope="module")
def jax_harness():
    """tools/bench_node_dots.py loaded by path, its shape globals set small."""
    spec = importlib.util.spec_from_file_location("_jax_bench_node_dots",
                                                  os.path.join(ROOT, "tools", "bench_node_dots.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in SMALL.items():
        setattr(mod, name, value)
    return mod


@pytest.fixture(scope="module")
def harness_inputs():
    sh = SMALL
    rng = np.random.default_rng(5)
    f = lambda *s: _bf16_np(rng.normal(size=s).astype(np.float32) * 0.5)
    return dict(hh=f(sh["T"], sh["B"], sh["NP"], sh["KI"]), w=f(sh["NP"], sh["KI"], sh["O"]),
                e=f(sh["NP"], sh["D"]), pool=f(sh["KI"], sh["D"] * sh["O"]),
                s=np.full((1, 1), 0.0123, np.float32))


def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def test_node_dots_plain_matches_jax_variant_a(jax_harness, harness_inputs):
    import jax.numpy as jnp

    sh, x = SMALL, harness_inputs
    hh_flat = x["hh"].reshape(sh["T"], sh["B"], sh["NP"] * sh["KI"])
    want = jax_harness.make_a(jnp.asarray(hh_flat, jnp.bfloat16), jnp.asarray(x["w"], jnp.bfloat16),
                              True)(jnp.asarray(x["s"]))
    got = node_dots(_bf(hh_flat), _bf(x["w"]), torch.from_numpy(x["s"]))
    assert got.dtype == torch.bfloat16 and got.shape == (sh["B"], sh["NP"] * sh["O"])
    _assert_within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_factored_rows_plain_matches_jax_variant_b(jax_harness, harness_inputs):
    import jax.numpy as jnp

    sh, x = SMALL, harness_inputs
    rows = sh["B"] * sh["NP"]
    hh_rows = x["hh"].reshape(sh["T"], rows, sh["KI"])
    e_rows = np.tile(x["e"], (sh["B"], 1))
    want = jax_harness.make_b(jnp.asarray(hh_rows, jnp.bfloat16), jnp.asarray(e_rows, jnp.bfloat16),
                              jnp.asarray(x["pool"], jnp.bfloat16), True)(jnp.asarray(x["s"]))
    got = node_apply.node_factored_rows(_bf(hh_rows), _bf(e_rows), _bf(x["pool"]), torch.from_numpy(x["s"]))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, sh["O"])
    _assert_within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_read_floor_plain_matches_jax_variant_d_bit_for_bit(jax_harness, harness_inputs):
    import jax.numpy as jnp

    sh, x = SMALL, harness_inputs
    hh_flat = x["hh"].reshape(sh["T"], sh["B"], sh["NP"] * sh["KI"])
    want = jax_harness.make_d(jnp.asarray(hh_flat, jnp.bfloat16), jnp.asarray(x["w"], jnp.bfloat16),
                              True)(jnp.asarray(x["s"]))
    got, words = stream_read.node_dots_floor(_bf(hh_flat), _bf(x["w"]), torch.from_numpy(x["s"]), sh["BLK"])
    assert got.dtype == torch.bfloat16 and got.shape == (sh["B"], sh["O"])
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    words_np = np.concatenate([_bf(hh_flat).view(torch.int32).numpy().ravel(),
                               _bf(x["w"]).view(torch.int32).numpy().ravel()])
    assert stream_read.checksum_value(words) == int(words_np.astype(np.int64).sum()) % 2 ** 32


# ---------------------------------------------------------------- B10 and the stream rate


@pytest.mark.parametrize("block_rows,width", [(8, 128), (16, 256)])
def test_column_sum_read_plain_matches_the_grid_formula(block_rows, width):
    rng = np.random.default_rng(block_rows)
    rows = 64
    x = _bf16_np(rng.normal(size=(rows, width)).astype(np.float32))
    s = np.full((1, 1), 0.375, np.float32)
    got, words = stream_read.column_sum_read(_bf(x), torch.from_numpy(s), block_rows)
    want = (rows // block_rows) * 0.375 + x[:, :128].astype(np.float64).sum(0, keepdims=True)
    assert got.dtype == torch.float32 and got.shape == (1, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert stream_read.checksum_value(words) == int(_bf(x).view(torch.int32).numpy().astype(np.int64).sum()) % 2 ** 32


@pytest.mark.parametrize("streams", [1, 3])
def test_stream_rate_read_plain_matches_the_kernel_formula(streams):
    rng = np.random.default_rng(streams)
    arrays = [_bf16_np(rng.normal(size=(4, 8, 512)).astype(np.float32)) for _ in range(streams)]
    s = np.full((1, 1), -0.5, np.float32)
    got, _ = stream_read.stream_rate_read([_bf(a) for a in arrays], torch.from_numpy(s))
    acc = s[0, 0] + arrays[0][-1, 0:1, :]
    for a in arrays[1:]:
        acc = acc + a[-1, 0:1, :]
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))


# ---------------------------------------------------------------- wrappers refuse


def test_wrappers_reject_wrong_dtypes_ranks_and_devices():
    hh = torch.zeros(B, K, N, I)
    e = torch.zeros(N, D)
    mat, mat_t = node_apply.pool_to_kernel_layout(torch.zeros(D, K, I, O))
    with pytest.raises(TypeError):
        node_apply.node_factored_apply(hh.to(torch.float16), e, mat.to(torch.float16))
    with pytest.raises(TypeError):
        node_apply.node_factored_apply(hh, e, mat.to(torch.bfloat16))
    with pytest.raises(ValueError, match="rank"):
        node_apply.node_factored_apply(hh[0], e, mat)
    with pytest.raises(ValueError, match="shape"):
        node_apply.node_factored_apply(hh, e[:-1].contiguous(), mat)
    with pytest.raises(ValueError, match="contiguous"):
        node_apply.node_factored_apply(hh.transpose(0, 1).contiguous().transpose(0, 1), e, mat)
    # K*I = 4096: more than B1's bf16 kernel holds beside its ring; its f32
    # kernel's shared memory does not grow with K*I, so f32 takes it
    with pytest.raises(ValueError, match="at most"):
        node_apply.node_factored_apply(torch.zeros(1, 1, 2, 4096, dtype=torch.bfloat16), torch.zeros(2, 1),
                                       torch.zeros(1, 4096, 8, dtype=torch.bfloat16))
    assert torch.equal(node_apply.node_factored_apply(torch.zeros(1, 1, 2, 4096), torch.zeros(2, 1),
                                                      torch.zeros(1, 4096, 8)), torch.zeros(1, 2, 8))
    dpre = torch.zeros(B, N, O)
    with pytest.raises(TypeError):
        node_apply.node_factored_apply_t(dpre.double(), e, mat_t.double())
    with pytest.raises(TypeError):
        node_apply.node_factored_apply_t(dpre, e, mat_t, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="shape"):
        node_apply.node_factored_apply_t(dpre[:, :, :-1].contiguous(), e, mat_t)
    with pytest.raises(ValueError, match="rank"):
        node_apply.node_factored_apply_t(dpre[0], e, mat_t)
    meta = torch.zeros(B, N, O, device="meta")
    with pytest.raises(ValueError, match="devices|CUDA or CPU"):
        node_apply.node_factored_apply_t(meta, e, mat_t)
    s = torch.zeros(1, 1)
    with pytest.raises(TypeError):
        node_apply.node_factored_rows(torch.zeros(2, 8, 24), torch.zeros(8, 3), torch.zeros(24, 48), s)
    hh_flat = torch.zeros(3, 4, 64 * 24, dtype=torch.bfloat16)
    w = torch.zeros(64, 24, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        node_dots(hh_flat.float(), w, s)
    with pytest.raises(ValueError, match="shape"):
        node_dots(hh_flat[:, :, :-24].contiguous(), w, s)
    with pytest.raises(ValueError, match="blk"):
        stream_read.node_dots_floor(hh_flat, w, s, 48)
    with pytest.raises(TypeError):
        stream_read.node_dots_floor(hh_flat, w, s.double(), 32)
    with pytest.raises(ValueError, match="width"):
        stream_read.column_sum_read(torch.zeros(64, 96, dtype=torch.bfloat16), s, 8)
    with pytest.raises(ValueError, match="16-byte"):
        stream_read.stream_rate_read([torch.zeros(2, 1, 6, dtype=torch.bfloat16)], s)
    with pytest.raises(ValueError, match="one shape"):
        stream_read.stream_rate_read([torch.zeros(2, 1, 8, dtype=torch.bfloat16),
                                      torch.zeros(2, 2, 8, dtype=torch.bfloat16)], s)


@pytest.mark.parametrize("ki,fits", [(448, True), (449, False)])
def test_node_dots_shared_memory_limit(ki, fits):
    """csrc/node_dots.cu keeps the node's (KI x 192) weight tile (KI padded
    to 64), a ring of four 64 x 64 activation chunks and a 64-row result
    tile in shared memory: KI up to 448 fits."""
    hh = torch.ones(1, 2, ki, dtype=torch.bfloat16)
    w = torch.ones(1, ki, 8, dtype=torch.bfloat16)
    s = torch.zeros(1, 1)
    if fits:
        assert torch.equal(node_dots(hh, w, s), torch.full((2, 8), float(ki), dtype=torch.bfloat16))
    else:
        with pytest.raises(ValueError, match="node_dots takes KI of at most 448, got 449"):
            node_dots(hh, w, s)


@pytest.mark.parametrize("dtype,ki,fits", [(torch.bfloat16, 576, True), (torch.bfloat16, 577, False),
                                           (torch.float32, 820, True), (torch.float32, 821, True),
                                           (torch.float32, 4096, True)])
def test_factored_shared_memory_limits(dtype, ki, fits):
    """B1 in bf16 keeps its tile's rows of K*I activations (padded to 64), a
    ring of four pool chunks and its f32 sums; its smallest tile (128 rows,
    16 columns) holds K*I up to 576, whatever D. In f32 the kernel streams
    the contraction in 16-row chunks through a ring whose size does not grow
    with K*I, so 821 and more fit, past the 820 that a layout holding 64
    rows' activations transposed took at D = 4."""
    if dtype == torch.float32:
        assert node_apply.factored_max_ki(dtype) == 2 ** 31 - 1
    e = torch.ones(3, 4)
    hh = torch.ones(2, 1, 3, ki, dtype=dtype)
    mat = torch.ones(1, ki, 4 * 5, dtype=dtype)
    rows = torch.ones(1, 3, ki, dtype=torch.bfloat16)
    pool = torch.ones(ki, 4 * 5, dtype=torch.bfloat16)
    s = torch.zeros(1, 1)
    if fits:
        assert torch.equal(node_apply.node_factored_apply(hh, e, mat), torch.full((2, 3, 5), 4.0 * ki))
        if dtype == torch.bfloat16:
            want = torch.full((3, 5), 4.0 * ki).to(torch.bfloat16)
            assert torch.equal(node_apply.node_factored_rows(rows, e, pool, s), want)
        return
    with pytest.raises(ValueError, match="node_factored_apply takes K.I of at most {}, got {}".format(ki - 1, ki)):
        node_apply.node_factored_apply(hh, e, mat)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="node_factored_rows takes KI of at most 576, got 577"):
            node_apply.node_factored_rows(rows, e, pool, s)


@pytest.mark.parametrize("dtype,o,fits", [(torch.bfloat16, 256, True), (torch.bfloat16, 257, False),
                                          (torch.float32, 824, True), (torch.float32, 2000, True)])
def test_factored_t_o_limits(dtype, o, fits):
    """B1t in bf16 holds its rows' dpre as register fragments of up to 16
    k16 slices (O up to 256); in f32 it walks O in chunks of 16, so any O
    that the kernel's int arguments hold (past the 824 of the q tile that
    its first f32 form kept in shared memory)."""
    assert node_apply.factored_t_max_o(dtype) == (256 if dtype == torch.bfloat16 else 2 ** 31 - 1)
    dpre = torch.ones(1, 2, o, dtype=dtype)
    e = torch.ones(2, 1)
    mat_t = torch.ones(1, o, 3, dtype=dtype)
    if fits:
        want = torch.full((1, 1, 2, 3), float(o)).to(dtype)
        assert torch.equal(node_apply.node_factored_apply_t(dpre, e, mat_t), want)
        return
    with pytest.raises(ValueError, match="node_factored_apply_t takes O of at most {} in".format(o - 1)):
        node_apply.node_factored_apply_t(dpre, e, mat_t)


@pytest.mark.parametrize("cell,o", [("gate", 128), ("update", 64)])
def test_expanded_order_holds_the_f32_plain_version_within_a_tenth_of_the_rule(cell, o):
    """B1t's f32 kernel sums in the expanded order, W[n,k,o,i] = sum_d
    e[n,d] pool_t[k, d O + o, i] first, then sum_o dpre[b,n,o] W; the plain
    version in the Pallas kernel's order, q = e dpre first. At the flagship
    cells (B=16, N=237, K=5, I=64, D=20) the two differ by rounding alone,
    under a tenth of the f32 rule the card holds the kernel to (rtol 1e-5,
    atol 1e-5 max|plain|): the order change sits far inside that check."""
    rng = np.random.default_rng(14)
    b, k, n, i, d = 16, 5, 237, 64, 20
    dpre = torch.from_numpy(rng.normal(size=(b, n, o)).astype(np.float32) * 0.1)
    e = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 0.1)
    _, mat_t = node_apply.pool_to_kernel_layout(torch.from_numpy(rng.normal(size=(d, k, i, o)).astype(np.float32) * 0.1))
    plain = node_apply.node_factored_apply_t_plain(dpre, e, mat_t)
    w = torch.einsum("nd,kdoi->nkoi", e, mat_t.view(k, d, o, i))
    expanded = torch.einsum("bno,nkoi->bkni", dpre, w)
    bound = 1e-5 * (plain.abs() + plain.abs().max())
    assert ((expanded - plain).abs() / bound).max().item() < 0.1


@pytest.mark.parametrize("cell,o", [("gate", 128), ("update", 64)])
def test_b1_expanded_order_holds_the_f32_plain_version_within_a_tenth_of_the_rule(cell, o):
    """B1's f32 kernel sums in the expanded order, W[n,(k,i),o] = sum_d
    e[n,d] pool[k,i,d O + o] first, then sum_{k,i} hh[b,k,n,i] W; the plain
    version in the Pallas kernel's order, r_d = hh @ pool_d first. At the
    flagship cells (B=16, N=237, K=5, I=64, D=20) the two differ by rounding
    alone, under a tenth of the f32 rule the card holds the kernel to (rtol
    1e-5, atol 1e-5 max|plain|)."""
    rng = np.random.default_rng(18)
    b, k, n, i, d = 16, 5, 237, 64, 20
    hh = torch.from_numpy(rng.normal(size=(b, k, n, i)).astype(np.float32) * 0.1)
    e = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 0.1)
    mat, _ = node_apply.pool_to_kernel_layout(torch.from_numpy(rng.normal(size=(d, k, i, o)).astype(np.float32) * 0.1))
    plain = node_apply.node_factored_apply_plain(hh, e, mat)
    w = torch.einsum("nd,kido->nkio", e, mat.view(k, i, d, o))
    expanded = torch.einsum("bkni,nkio->bno", hh, w)
    bound = 1e-5 * (plain.abs() + plain.abs().max())
    assert ((expanded - plain).abs() / bound).max().item() < 0.1


def test_factored_f32_planted_faults_leave_the_cpu_path_alone():
    """B1's planted faults (d = 0 dropped, the last 16-row chunk dropped,
    cluster rank 0's partial dropped) live in its f32 kernel alone."""
    g = torch.Generator().manual_seed(18)
    hh = torch.randn(2, 3, 5, 7, generator=g)
    e = torch.randn(5, 2, generator=g)
    mat = torch.randn(3, 7, 2 * 6, generator=g)
    want = node_apply.node_factored_apply(hh, e, mat)
    assert set(node_apply.B1_FAULTS) == set(node_apply.FAULTS) | {"rank"}
    for kind in sorted(node_apply.B1_FAULTS):
        with node_apply.planted_fault(kind):
            assert node_apply._planted == node_apply.B1_FAULTS[kind]
            assert torch.equal(node_apply.node_factored_apply(hh, e, mat), want)
        assert node_apply._planted == 0


@pytest.mark.parametrize("i,o,path", [(64, 128, "pool TMA, hh TMA"), (64, 5, "pool cp.async, hh TMA"),
                                      (7, 64, "pool TMA, hh cp.async"), (7, 5, "pool cp.async, hh cp.async")])
def test_factored_f32_takes_operands_by_tma_only_in_whole_16_byte_rows(i, o, path):
    assert node_apply.factored_load_path(i, o) == path


def test_factored_t_f32_planted_faults_leave_the_cpu_path_alone():
    g = torch.Generator().manual_seed(6)
    dpre = torch.randn(2, 5, 6, generator=g)
    e = torch.randn(5, 2, generator=g)
    mat_t = torch.randn(3, 12, 4, generator=g)
    want = node_apply.node_factored_apply_t(dpre, e, mat_t)
    for kind in sorted(node_apply.FAULTS):
        with node_apply.planted_fault(kind):
            assert torch.equal(node_apply.node_factored_apply_t(dpre, e, mat_t), want)


@pytest.mark.parametrize("i,path", [(64, "TMA"), (8, "TMA"), (72, "TMA"), (7, "element loads"),
                                    (12, "element loads")])
def test_factored_t_takes_pool_t_by_tma_only_in_whole_16_byte_rows(i, path):
    assert node_apply.factored_t_load_path(i) == path


def test_einsum_order_names_the_contraction_torch_takes():
    """B1t's library call at the flagship gate: through opt_einsum torch
    forms the per-node weights first (0.70 GFLOP), left to right it forms
    e x dpre first and then the factored contraction (6.22 GFLOP)."""
    from multistgraph_tpu_torch.tools.timing import einsum_order

    ops = [torch.empty(*s, device="meta") for s in ((16, 237, 128), (237, 20), (5, 20, 128, 64))]
    if torch.backends.opt_einsum.is_available():
        got = einsum_order("bno,nd,kdoi->bkni", *ops)
        assert got["opt_einsum"] and [s["einsum"] for s in got["steps"]] == ["nd,kdoi->nkoi", "bno,nkoi->bnki"]
        assert got["flops"] == 2 * 237 * 20 * 5 * 128 * 64 + 2 * 16 * 237 * 128 * 5 * 64
    with torch.backends.opt_einsum.flags(enabled=False):
        got = einsum_order("bno,nd,kdoi->bkni", *ops)
    assert not got["opt_einsum"] and [s["einsum"] for s in got["steps"]] == ["bno,nd->bnod", "kdoi,bnod->kibn"]
    assert got["flops"] == 16 * 237 * 128 * 20 + 2 * 16 * 237 * 128 * 20 * 5 * 64


def test_factored_t_planted_faults_are_scoped_and_leave_the_cpu_path_alone():
    g = torch.Generator().manual_seed(3)
    dpre = (torch.randn(2, 5, 6, generator=g)).to(torch.bfloat16)
    e = torch.randn(5, 2, generator=g)
    mat_t = torch.randn(3, 12, 4, generator=g).to(torch.bfloat16)
    want = node_apply.node_factored_apply_t(dpre, e, mat_t)
    with pytest.raises(KeyError):
        with node_apply.planted_fault("no such fault"):
            pass
    for kind in sorted(node_apply.FAULTS):
        with node_apply.planted_fault(kind):
            assert node_apply._planted == node_apply.FAULTS[kind]
            assert torch.equal(node_apply.node_factored_apply_t(dpre, e, mat_t), want)
        assert node_apply._planted == 0


# B11 A and B at the harness shapes: one step's activations, its operations
_STEP_A = (16 * 256 * 320 * 2, 2 * 16 * 256 * 320 * 192)
_STEP_B = (16 * 256 * 320 * 2, 2 * 16 * 256 * 320 * 20 * 192)


@pytest.mark.parametrize("step,by_bytes", [(_STEP_A, True), (_STEP_B, False)])
def test_step_floor_is_the_extra_steps_at_the_peaks(step, by_bytes):
    step_bytes, step_flops = step
    floor = timing.step_floor_ms(24, step_bytes, step_flops)
    per_step = step_bytes / 3.35e12 if by_bytes else step_flops / 989e12
    assert floor == pytest.approx(23 * per_step * 1e3, rel=1e-12)
    assert timing.step_floor_ms(1, step_bytes, step_flops) == 0.0


@pytest.mark.parametrize("step,ms_all,ms_one", [(_STEP_A, 0.052, 0.016), (_STEP_A, 1.332, 0.0833),
                                                (_STEP_B, 0.55, 0.03), (_STEP_B, 12.96, 0.652)])
def test_every_step_check_passes_honest_timings_and_fails_a_step_skip(step, ms_all, ms_one):
    """Readings shaped like the tensor-core and the earlier SIMT kernels' pass;
    the one-step time in the T-step time's place (a kernel that skipped the
    overwritten steps) fails, as does a kernel that ran a quarter of them."""
    step_bytes, step_flops = step
    assert timing.every_step_ran(ms_all, ms_one, 24, step_bytes, step_flops)
    assert not timing.every_step_ran(ms_one, ms_one, 24, step_bytes, step_flops)
    floor = timing.step_floor_ms(24, step_bytes, step_flops)
    assert not timing.every_step_ran(ms_one + floor / 4, ms_one, 24, step_bytes, step_flops)


def test_node_dots_plain_keeps_the_last_step():
    """Earlier steps are overwritten: only hh[T-1] reaches the output."""
    rng = np.random.default_rng(9)
    hh = _bf(rng.normal(size=(3, 4, 8 * 24)).astype(np.float32))
    w = _bf(rng.normal(size=(8, 24, 16)).astype(np.float32))
    s = torch.zeros(1, 1)
    other = hh.clone()
    other[:-1] = 0
    assert torch.equal(node_dots_plain(hh, w, s), node_dots_plain(other, w, s))


# ---------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _randn(g, *shape, dtype=torch.float32, scale=0.3):
    return (torch.randn(*shape, generator=g) * scale).to(dtype).to("cuda")


def _assert_close_to_plain(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,i,d,o", [(16, 5, 237, 64, 20, 128), (16, 5, 237, 64, 20, 64),
                                          (2, 3, 140, 8, 4, 16), (3, 1, 65, 7, 1, 40), (2, 2, 33, 6, 3, 18)])
def test_cuda_factored_apply_matches_plain(cuda, dtype, b, k, n, i, d, o):
    g = torch.Generator().manual_seed(n * o + d)
    hh = _randn(g, b, k, n, i, dtype=dtype)
    e = _randn(g, n, d)
    mat, mat_t = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o, dtype=dtype))
    before = node_apply.node_factored_apply.launches
    got = node_apply.node_factored_apply(hh, e, mat)
    assert node_apply.node_factored_apply.launches == before + 1
    _assert_close_to_plain(got, node_apply.node_factored_apply_plain(hh, e, mat))
    dpre = _randn(g, b, n, o, dtype=dtype)
    before = node_apply.node_factored_apply_t.launches
    got_t = node_apply.node_factored_apply_t(dpre, e, mat_t)
    assert node_apply.node_factored_apply_t.launches == before + 1 and got_t.dtype == dtype
    want_t = node_apply.node_factored_apply_t_plain(dpre, e, mat_t)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        _assert_close_to_plain(got_t, want_t)
    else:
        _assert_within_one_bf16_step(got_t.float().cpu().numpy(), want_t.float().cpu().numpy())
        f32 = node_apply.node_factored_apply_t(dpre, e, mat_t, out_dtype=torch.float32)
        _assert_close_to_plain(f32, node_apply.node_factored_apply_t_plain(dpre, e, mat_t, torch.float32))


def _factored_tile_fn():
    import ctypes

    from multistgraph_tpu_torch.ops import _cuda

    fn = _cuda.library("node_factored").node_factored_fwd_tile
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [-1, 0, 1, 2, 3])
@pytest.mark.parametrize("b,k,n,i,d,o", [(16, 5, 237, 64, 20, 128), (16, 5, 237, 64, 20, 64), (3, 2, 45, 7, 1, 5),
                                          (2, 3, 33, 64, 20, 64), (17, 1, 40, 7, 20, 128), (2, 5, 21, 64, 1, 5),
                                          (5, 2, 70, 36, 9, 30)])
def test_cuda_factored_f32_tiles_and_edges(cuda, b, k, n, i, d, o, tile):
    """B1 with f32 operands, the expanded order, through each of its tiles
    (the 16-row chunks of (k, i) split over 1 to 8 blocks of a cluster, more
    blocks than chunks at I = 7) and the one chosen (-1): the flagship gate
    and update; ragged N (45, 33, 21, 70: no multiple of 16 nodes) and B (17:
    a second b tile); I = 7 and 36 (hh by 4-byte copies, ragged chunks), O =
    5 and 30 (the pool by 4-byte copies, a ragged column tile), 64 and 128;
    D = 1, 9 and 20 (ragged 8-d pieces). Within the f32 rule of the plain
    version; two calls bit-identical."""
    g = torch.Generator().manual_seed(b * 1000 + i * 10 + o + d)
    hh = _randn(g, b, k, n, i)
    e = _randn(g, n, d)
    mat, _ = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o))
    want = node_apply.node_factored_apply_plain(hh, e, mat)
    outs = []
    for _ in range(2):
        out = torch.full((b, n, o), float("nan"), device="cuda")
        rc = _factored_tile_fn()(hh.data_ptr(), e.data_ptr(), mat.data_ptr(), None, out.data_ptr(), 1, b, k, n, i, d,
                                 o, 0, 0, tile, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        outs.append(out)
    _assert_close_to_plain(outs[0], want)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("i", [64, 7])
@pytest.mark.parametrize("fault", sorted(node_apply.B1_FAULTS))
def test_cuda_factored_f32_planted_faults_fail_the_check(cuda, fault, i):
    """Each fault planted in B1's f32 kernel (d = 0 dropped, the last 16-row
    chunk of the contraction dropped, cluster rank 0's partial dropped: the
    tile chosen here splits the chunks) takes it past the f32 rule, on both
    load paths of hh; outside the block it passes."""
    g = torch.Generator().manual_seed(41 + i)
    b, k, n, d, o = 4, 3, 70, 5, 40
    assert node_apply.factored_tile(b, k, n, i, o) != node_apply.factored_f32_tile_name(0)
    hh = _randn(g, b, k, n, i)
    e = _randn(g, n, d)
    mat, _ = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o))
    want = node_apply.node_factored_apply_plain(hh, e, mat)
    with node_apply.planted_fault(fault):
        bad = node_apply.node_factored_apply(hh, e, mat)
    with pytest.raises(AssertionError):
        _assert_close_to_plain(bad, want)
    _assert_close_to_plain(node_apply.node_factored_apply(hh, e, mat), want)


@pytest.mark.cuda
def test_cuda_factored_f32_tile_fills_the_card(cuda):
    """B1's f32 kernel splits an item's chunks over the blocks of a cluster
    whose busiest SM has the least work: the flagship gate's 60 items and
    the update's 30 over 4 blocks each on an H100's 132 SMs."""
    assert node_apply.factored_tile(16, 5, 237, 64, 128) == "16x32, chunks over 4"
    assert node_apply.factored_tile(16, 5, 237, 64, 64) == "16x32, chunks over 4"
    assert node_apply.factored_tile(1, 1, 16, 7, 32) == "16x32, chunks over 1"


def _factored_t_tile_fn():
    import ctypes

    from multistgraph_tpu_torch.ops import _cuda

    fn = _cuda.library("node_factored_t").node_factored_t_bwd_tile
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tile", [0, 1, 2, 3])
@pytest.mark.parametrize("b,k,n,i,d,o", [(16, 5, 237, 64, 20, 128), (3, 3, 43, 7, 2, 40), (2, 2, 33, 8, 3, 18),
                                          (1, 1, 65, 72, 4, 200), (2, 4, 50, 16, 1, 64)])
def test_cuda_factored_t_tensor_core_tiles_and_edges(cuda, b, k, n, i, d, o, tile, out_dtype):
    """B1t in bf16 on wgmma through each of its tiles (128 and 64 rows, one or
    two k a block): ragged M (B*N not a multiple of the tile's rows), O = 18,
    40 and 200 (no multiple of 16 or 64: each d's contraction padded on its
    own), I = 7 (element loads), 8 and 16 (narrow TMA boxes), 72 (a second,
    ragged i-block), K not a multiple of 2, and an f32 out_dtype; within one
    bf16 step of the plain version, and rtol 1e-5 for the f32 result (the
    same exact products of q and pool_t summed in f32 in another order)."""
    g = torch.Generator().manual_seed(b * 1000 + i * 10 + o + tile)
    dpre = _randn(g, b, n, o, dtype=torch.bfloat16)
    e = _randn(g, n, d, dtype=torch.bfloat16)
    _, mat_t = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o, dtype=torch.bfloat16))
    want = node_apply.node_factored_apply_t_plain(dpre, e, mat_t, out_dtype)
    out = torch.full((b, k, n, i), float("nan"), dtype=out_dtype, device="cuda")
    rc = _factored_t_tile_fn()(dpre.data_ptr(), e.data_ptr(), mat_t.data_ptr(), out.data_ptr(), b, k, n, i, d, o, 1,
                               int(out_dtype == torch.bfloat16), tile, 0, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    if out_dtype == torch.float32:
        _assert_close_to_plain(out, want)
    else:
        _assert_within_one_bf16_step(out.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("i", [64, 7])
@pytest.mark.parametrize("fault", sorted(node_apply.FAULTS))
def test_cuda_factored_t_planted_faults_fail_the_check(cuda, fault, i):
    """Each fault planted in B1t's kernels (d = 0 dropped, the last k16
    slice of the contraction dropped; in f32 the 16 o holding the last)
    takes the bf16 form past one bf16 step and the f32 form past the f32
    rule, on both load paths; outside the block both pass."""
    g = torch.Generator().manual_seed(31 + i)
    b, k, n, d, o = 4, 3, 70, 5, 40
    dpre = _randn(g, b, n, o, dtype=torch.bfloat16)
    e = _randn(g, n, d)
    _, mat_t = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o, dtype=torch.bfloat16))
    want = node_apply.node_factored_apply_t_plain(dpre, e, mat_t).float().cpu().numpy()
    want_f32 = node_apply.node_factored_apply_t_plain(dpre.float(), e, mat_t.float())
    with node_apply.planted_fault(fault):
        bad = node_apply.node_factored_apply_t(dpre, e, mat_t).float().cpu().numpy()
        bad_f32 = node_apply.node_factored_apply_t(dpre.float(), e, mat_t.float())
    with pytest.raises(AssertionError):
        _assert_within_one_bf16_step(bad, want)
    with pytest.raises(AssertionError):
        _assert_close_to_plain(bad_f32, want_f32)
    _assert_within_one_bf16_step(node_apply.node_factored_apply_t(dpre, e, mat_t).float().cpu().numpy(), want)
    _assert_close_to_plain(node_apply.node_factored_apply_t(dpre.float(), e, mat_t.float()), want_f32)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [0, 1, 2, 3])
@pytest.mark.parametrize("b,k,n,i,d,o", [(16, 5, 237, 64, 20, 128), (16, 5, 237, 64, 20, 64), (3, 5, 21, 36, 20, 20),
                                          (17, 1, 9, 17, 1, 128), (2, 5, 33, 17, 20, 64), (5, 1, 40, 36, 1, 20),
                                          (1, 5, 7, 64, 9, 30), (2, 2, 70, 8, 50, 18)])
def test_cuda_factored_t_f32_groups_and_edges(cuda, b, k, n, i, d, o, tile, out_dtype):
    """B1t with f32 operands, the expanded order, through its tiles (O split
    over 1 to 8 blocks of a cluster, more blocks than 16-o chunks at O =
    20, 30 and 18): the flagship gate and update; B*N and B no multiple
    of the 16 nodes of a block or of 16 b (a second b tile at B = 17); I =
    64, 36, 17 and 8 (4-byte copies and stores at 17), O = 128, 64, 20, 30
    and 18 (4-byte dpre copies, a ragged 16-o chunk), D = 1, 9, 20 and 50
    (ragged 8-d pieces), K = 1, 2 and 5.
    The f32 result within the f32 rule of the plain version (the same
    function in the other order: about 1e-6 of max|plain| on the CPU), the
    bf16 one within one bf16 step of the plain version rounded to bf16."""
    g = torch.Generator().manual_seed(b * 1000 + i * 10 + o + tile)
    dpre = _randn(g, b, n, o)
    e = _randn(g, n, d)
    _, mat_t = node_apply.pool_to_kernel_layout(_randn(g, d, k, i, o))
    want = node_apply.node_factored_apply_t_plain(dpre, e, mat_t, torch.float32)
    out = torch.full((b, k, n, i), float("nan"), dtype=out_dtype, device="cuda")
    rc = _factored_t_tile_fn()(dpre.data_ptr(), e.data_ptr(), mat_t.data_ptr(), out.data_ptr(), b, k, n, i, d, o, 0,
                               int(out_dtype == torch.bfloat16), tile, 0, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    if out_dtype == torch.float32:
        _assert_close_to_plain(out, want)
    else:
        _assert_within_one_bf16_step(out.float().cpu().numpy(), want.to(torch.bfloat16).float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_factored_t_f32_tile_fills_the_card(cuda):
    """The f32 kernel's 16 nodes x 32 columns split O over the most blocks
    of a cluster that leave each two 16-o chunks: 4 at the flagship gate
    (600 blocks), 2 at the update."""
    assert node_apply.factored_t_tile(16, 5, 237, 64, torch.float32, o=128) == "16x32, O over 4"
    assert node_apply.factored_t_tile(16, 5, 237, 64, torch.float32, o=64) == "16x32, O over 2"
    assert node_apply.factored_t_tile(2, 1, 40, 32, torch.float32, o=20) == "16x32, O over 1"


@pytest.mark.cuda
def test_cuda_factored_t_unaligned_tma_operand_raises(cuda):
    """At I % 8 == 0 B1t's bf16 kernel views pool_t by TMA: a pool_t whose
    address is not 16-byte aligned cannot be viewed, so the launch fails and
    the wrapper raises, rather than take the element loads unannounced."""
    g = torch.Generator().manual_seed(9)
    b, k, n, i, d, o = 2, 2, 40, 16, 3, 32
    pool_t = _randn(g, k * d * o * i + 1, dtype=torch.bfloat16)[1:].view(k, d * o, i)
    assert pool_t.is_contiguous() and pool_t.data_ptr() % 16
    with pytest.raises(RuntimeError, match="node_factored_t kernel launch failed"):
        node_apply.node_factored_apply_t(_randn(g, b, n, o, dtype=torch.bfloat16), _randn(g, n, d), pool_t)


@pytest.mark.cuda
@pytest.mark.parametrize("ki,o", [(40, 24), (36, 20)])
def test_cuda_harness_kernels_match_plain(cuda, ki, o):
    """B11 A, B (B1's kernel on rows) and D at reduced harness shapes; KI
    and O multiples of 8 take the kernels' 16-byte loads, the others not."""
    g = torch.Generator().manual_seed(ki)
    t, b, np_, d, blk = 3, 4, 64, 3, 32
    hh = _randn(g, t, b, np_ * ki, dtype=torch.bfloat16)
    w = _randn(g, np_, ki, o, dtype=torch.bfloat16)
    s = torch.full((1, 1), 0.0123, device="cuda")
    got = node_dots(hh, w, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(), node_dots_plain(hh, w, s).float().cpu().numpy())
    hh_rows = hh.reshape(t, b * np_, ki)
    e_rows = _randn(g, np_, d, dtype=torch.bfloat16).repeat(b, 1)
    pool = _randn(g, ki, d * o, dtype=torch.bfloat16)
    got = node_apply.node_factored_rows(hh_rows, e_rows, pool, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(),
                                 node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s).float().cpu().numpy())
    got, words = stream_read.node_dots_floor(hh, w, s, blk)
    want, want_words = stream_read.node_dots_floor_plain(hh, w, s, blk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert stream_read.checksum_value(words) == stream_read.checksum_value(want_words)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("ki,o", [(40, 24), (36, 18)])
@pytest.mark.parametrize("b", [1, 4, 16, 20])
def test_cuda_node_dots_tensor_core_edges(cuda, b, ki, o, t):
    """B11 A on wgmma: B other than 16 leaves a partial or second 16-row
    unit, KI = 40 and 36 are not multiples of 16 (36 and O = 18 not of 8
    either: element loads), O = 18 and 24 leave a ragged column tile."""
    g = torch.Generator().manual_seed(100 * b + ki + t)
    np_ = 5
    hh = _randn(g, t, b, np_ * ki, dtype=torch.bfloat16)
    w = _randn(g, np_, ki, o, dtype=torch.bfloat16)
    s = torch.full((1, 1), -0.25, device="cuda")
    before = node_dots.launches
    got = node_dots(hh, w, s)
    assert node_dots.launches == before + 1
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(), node_dots_plain(hh, w, s).float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("rows,ki,d,o", [(100, 40, 3, 24), (77, 36, 2, 18), (300, 24, 5, 40), (129, 48, 1, 72)])
def test_cuda_factored_rows_tensor_core_edges(cuda, rows, ki, d, o, t):
    """B11 B on wgmma: ragged M (rows not a multiple of the 64- or 128-row
    tile), K*I not a multiple of 16 (and 36 not of 8), O not a multiple of 8
    or of the column tile; every step overwrites the last."""
    g = torch.Generator().manual_seed(rows + ki + t)
    hh_rows = _randn(g, t, rows, ki, dtype=torch.bfloat16)
    e_rows = _randn(g, rows, d, dtype=torch.bfloat16)
    pool = _randn(g, ki, d * o, dtype=torch.bfloat16)
    s = torch.full((1, 1), 0.5, device="cuda")
    got = node_apply.node_factored_rows(hh_rows, e_rows, pool, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(),
                                 node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s).float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("o", [40, 18])
@pytest.mark.parametrize("tile", [0, 1, 2, 3])
def test_cuda_factored_every_tile_matches_plain(cuda, tile, o):
    """Each of B1's bf16 tiles (192x32, 128x48, 128x32, 128x16; the wrapper
    takes one by the grid) through the kernel's tiled entry, on ragged rows,
    D not a multiple of the d a product takes, and O = 40 (TMA) or 18
    (element loads), within one bf16 step of the plain version."""
    import ctypes

    from multistgraph_tpu_torch.ops import _cuda

    fn = _cuda.library("node_factored").node_factored_fwd_tile
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    g = torch.Generator().manual_seed(tile * 100 + o)
    t, rows, ki, d = 2, 300, 48, 7
    hh_rows = _randn(g, t, rows, ki, dtype=torch.bfloat16)
    e_rows = _randn(g, rows, d)
    pool = _randn(g, ki, d * o, dtype=torch.bfloat16)
    s = torch.full((1, 1), 0.5, device="cuda")
    out = torch.empty(rows, o, dtype=torch.bfloat16, device="cuda")
    rc = fn(hh_rows.data_ptr(), e_rows.data_ptr(), pool.data_ptr(), s.data_ptr(), out.data_ptr(), t, 1, 1, rows, ki,
            d, o, 1, 1, tile, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(out.float().cpu().numpy(),
                                 node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s).float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_node_dots_second_column_tile_and_partial_row_tile(cuda):
    """B11 A at B = 16 (TMA) with O = 200 (a second, ragged 192-column
    tile) and 9 steps (a partial last 64-row tile), within one bf16 step of
    the plain version."""
    g = torch.Generator().manual_seed(192)
    t, b, np_, ki, o = 9, 16, 3, 72, 200
    hh = _randn(g, t, b, np_ * ki, dtype=torch.bfloat16)
    w = _randn(g, np_, ki, o, dtype=torch.bfloat16)
    s = torch.full((1, 1), -0.25, device="cuda")
    got = node_dots(hh, w, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(), node_dots_plain(hh, w, s).float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_unaligned_tma_operand_raises(cuda):
    """Where the shape takes TMA, an operand whose address is not 16-byte
    aligned cannot be viewed: the launch fails and the wrapper raises, rather
    than take the element loads unannounced."""
    g = torch.Generator().manual_seed(7)
    t, b, np_, ki, o, d = 1, 16, 2, 32, 16, 2
    hh = _randn(g, t * b * np_ * ki + 1, dtype=torch.bfloat16)[1:].view(t, b, np_ * ki)
    w = _randn(g, np_, ki, o, dtype=torch.bfloat16)
    s = torch.zeros(1, 1, device="cuda")
    with pytest.raises(RuntimeError, match="node_dots kernel launch failed"):
        node_dots(hh, w, s)
    pool = _randn(g, ki * d * o + 1, dtype=torch.bfloat16)[1:].view(ki, d * o)
    with pytest.raises(RuntimeError, match="launch failed"):
        node_apply.node_factored_rows(_randn(g, 1, 70, ki, dtype=torch.bfloat16),
                                      _randn(g, 70, d, dtype=torch.bfloat16), pool, s)


@pytest.mark.cuda
def test_cuda_harness_kernels_at_the_full_harness_shape(cuda):
    """B11 A and B once at T=24, B=16, NP=256, KI=320, O=192, D=20."""
    g = torch.Generator().manual_seed(24)
    t, b, np_, ki, o, d = 24, 16, 256, 320, 192, 20
    hh = _randn(g, t, b, np_ * ki, dtype=torch.bfloat16, scale=0.1)
    w = _randn(g, np_, ki, o, dtype=torch.bfloat16, scale=0.1)
    s = torch.full((1, 1), 0.0123, device="cuda")
    got = node_dots(hh, w, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(), node_dots_plain(hh, w, s).float().cpu().numpy())
    hh_rows = hh.reshape(t, b * np_, ki)
    e_rows = _randn(g, np_, d, dtype=torch.bfloat16, scale=0.1).repeat(b, 1)
    pool = _randn(g, ki, d * o, dtype=torch.bfloat16, scale=0.1)
    got = node_apply.node_factored_rows(hh_rows, e_rows, pool, s)
    torch.cuda.synchronize()
    _assert_within_one_bf16_step(got.float().cpu().numpy(),
                                 node_apply.node_factored_rows_plain(hh_rows, e_rows, pool, s).float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,block_rows", [(4096, 512, 512), (2048, 1024, 2048), (24, 128, 8)])
def test_cuda_column_sum_read_matches_plain(cuda, rows, width, block_rows):
    g = torch.Generator().manual_seed(rows)
    x = _randn(g, rows, width, dtype=torch.bfloat16, scale=1.0)
    s = torch.full((1, 1), 0.25, device="cuda")
    got, words = stream_read.column_sum_read(x, s, block_rows)
    want, want_words = stream_read.column_sum_read_plain(x, s, block_rows)
    _assert_close_to_plain(got, want)
    assert stream_read.checksum_value(words) == stream_read.checksum_value(want_words)


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 2, 8])
def test_cuda_stream_rate_read_matches_plain(cuda, streams):
    g = torch.Generator().manual_seed(streams)
    arrays = [_randn(g, 5, 16, 512, dtype=torch.bfloat16, scale=1.0) for _ in range(streams)]
    s = torch.full((1, 1), -0.5, device="cuda")
    before = stream_read.stream_rate_read.launches
    got, words = stream_read.stream_rate_read(arrays, s)
    want, want_words = stream_read.stream_rate_read_plain(arrays, s)
    torch.cuda.synchronize()
    assert stream_read.stream_rate_read.launches == before + 1
    assert torch.equal(got, want)
    assert stream_read.checksum_value(words) == stream_read.checksum_value(want_words)
