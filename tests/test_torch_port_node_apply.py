"""Kernels B2 (int8 node apply), B2t (its transpose) and B3 (layout copy,
forward and backward) of the port.

On the CPU the wrappers take their plain versions, which are held against
the JAX package (the Pallas kernels in interpret mode). B2t's tolerance is
one bf16 step: both sides take the same bf16-rounded products, exact in
f32, and only the order of the f32 sums differs, which can move the final
rounding to bf16 by one step (at most 2^-7 of the value). The tests marked
``cuda`` hold each CUDA kernel against its plain version on the card and
skip without one; they import no JAX, so the file runs on a machine without
it:  python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_node_apply.py
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.ops import node_apply
from multistgraph_tpu_torch.ops.layout import force_default_layout, force_default_layout_plain
from multistgraph_tpu_torch.ops.node_apply import (
    _pad_nodes,
    node_apply_q8,
    node_apply_q8_plain,
    node_apply_q8_t,
    node_apply_q8_t_plain,
    quantize_node_weights,
)

N, B, KI, O = 37, 4, 24, 16  # N is not a multiple of the 32-node block


def _weights(seed=0, shape=(N, KI, O)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.2


def _jnp():
    import jax.numpy as jnp

    return jnp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_exactly(dtype):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import quantize_node_weights as jax_quantize

    w = _weights()
    wj = jnp.asarray(w).astype(dtype)
    qj, sj = jax_quantize(wj)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = quantize_node_weights(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_plain_apply_matches_jax_interpret():
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8 as jax_apply

    rng = np.random.default_rng(1)
    hh = rng.normal(size=(N, B, KI)).astype(np.float32)
    hh_j = jnp.asarray(hh).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()))
    want = np.asarray(jax_apply(hh_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True))
    hh_t = torch.from_numpy(np.array(hh_j.astype(jnp.float32))).to(torch.bfloat16)
    got = node_apply_q8(hh_t, wq, s)
    assert got.dtype == torch.float32 and got.shape == (N, B, O)
    # the same products; only the summation order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # padded weight rows (the model pads N to a 32-node block) are ignored
    padded = node_apply_q8(hh_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    np.testing.assert_array_equal(padded.numpy(), got.numpy())


def _assert_within_one_bf16_step(got, want, step=2.0 ** -7):
    """|got - want| <= 2^-7 |want| elementwise (one bf16 step: 8 significant
    bits, so a step is 2^-8 to 2^-7 of the value), plus a floor for sums that
    cancel to ~0; `step` 2^-10 for one f16 step (11 bits)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = step * np.abs(want) + step * 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("b", [1, 3, 17])
def test_plain_transposed_apply_matches_jax_interpret(b):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8_t as jax_apply_t

    rng = np.random.default_rng(b)
    dpre = rng.normal(size=(N, b, O)).astype(np.float32)
    dpre_j = jnp.asarray(dpre).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b)))
    # the model pads N to a multiple of 32 (37 -> 64); pad rows are ignored
    wq, s = _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64)
    want = jax_apply_t(dpre_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True)
    assert want.dtype == jnp.bfloat16
    dpre_t = torch.from_numpy(np.array(dpre_j.astype(jnp.float32))).to(torch.bfloat16)
    got = node_apply_q8_t(dpre_t, wq, s)
    assert got.dtype == torch.bfloat16 and got.shape == (N, b, KI)
    _assert_within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# edge shapes of the tensor-core kernels: batches on both sides of the
# 8-column tiles, O that is no multiple of 16 (element loads) or of 64, KI
# of H=16 (80) and of H=12 (60: hh rows no whole 16-byte units)
EDGE_SHAPES = [(1, 80, 16), (8, 80, 40), (9, 320, 64), (17, 60, 128), (33, 80, 20)]


@pytest.mark.parametrize("b,ki,o", EDGE_SHAPES)
def test_plain_apply_matches_jax_interpret_at_edge_shapes(b, ki, o):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8 as jax_apply

    rng = np.random.default_rng(100 + b)
    hh_j = jnp.asarray(rng.normal(size=(N, b, ki)).astype(np.float32)).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b, shape=(N, ki, o))))
    want = np.asarray(jax_apply(hh_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True))
    hh_t = torch.from_numpy(np.array(hh_j.astype(jnp.float32))).to(torch.bfloat16)
    # pad rows past N, as the model pads N to a 32-node block
    got = node_apply_q8(hh_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    assert got.dtype == torch.float32 and got.shape == (N, b, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("b,ki,o", EDGE_SHAPES)
def test_plain_transposed_apply_matches_jax_interpret_at_edge_shapes(b, ki, o):
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8_t as jax_apply_t

    rng = np.random.default_rng(200 + b)
    dpre_j = jnp.asarray(rng.normal(size=(N, b, o)).astype(np.float32)).astype(jnp.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b + 1, shape=(N, ki, o))))
    want = jax_apply_t(dpre_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True)
    dpre_t = torch.from_numpy(np.array(dpre_j.astype(jnp.float32))).to(torch.bfloat16)
    got = node_apply_q8_t(dpre_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    assert got.dtype == torch.bfloat16 and got.shape == (N, b, ki)
    _assert_within_one_bf16_step(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# f32 and f16 activations, JAX's "any float": the file's shape and the edge
# shapes above, each (batch, KI, O)
WIDE_SHAPES = [(B, KI, O)] + EDGE_SHAPES


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("b,ki,o", WIDE_SHAPES)
def test_plain_apply_of_f32_and_f16_activations_matches_jax_interpret(b, ki, o, dtype):
    """B2 contracts an f32 or f16 hh in full against the int8 weights, with
    f32 sums (rtol 1e-5, atol 1e-5 max): no rounding to bf16 on either side."""
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8 as jax_apply

    rng = np.random.default_rng(300 + b + ki)
    hh_j = jnp.asarray(rng.normal(size=(N, b, ki)).astype(np.float32)).astype(dtype)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b + 2, shape=(N, ki, o))))
    want = np.asarray(jax_apply(hh_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True))
    assert want.dtype == np.float32
    hh_t = torch.from_numpy(np.array(hh_j.astype(jnp.float32))).to(getattr(torch, dtype))
    got = node_apply_q8(hh_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    assert got.dtype == torch.float32 and got.shape == (N, b, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if dtype == "float32":  # f32 is not rounded to bf16 first: that would differ
        rounded = node_apply_q8(hh_t.to(torch.bfloat16), wq, s)
        assert not np.allclose(rounded.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dpre_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("b,ki,o", WIDE_SHAPES)
def test_plain_transposed_apply_of_any_float_matches_jax_interpret(b, ki, o, dpre_dtype):
    """B2t rounds bf16(dpre * scale) in f32 for any dpre, sums in f32 and
    writes dpre's dtype (JAX's default out_dtype): f32 held at rtol 1e-5,
    bf16 and f16 within one step of their dtype."""
    jnp = _jnp()
    from multistgraph_tpu.ops.node_apply import node_apply_q8_t as jax_apply_t

    rng = np.random.default_rng(400 + b + o)
    dpre_j = jnp.asarray(rng.normal(size=(N, b, o)).astype(np.float32)).astype(dpre_dtype)
    wq, s = quantize_node_weights(torch.from_numpy(_weights(seed=b + 3, shape=(N, ki, o))))
    want = jax_apply_t(dpre_j, jnp.asarray(wq.numpy()), jnp.asarray(s.numpy()), interpret=True)
    want_dtype = dpre_dtype
    assert want.dtype == jnp.dtype(want_dtype)
    dpre_t = torch.from_numpy(np.array(dpre_j.astype(jnp.float32))).to(getattr(torch, dpre_dtype))
    got = node_apply_q8_t(dpre_t, _pad_nodes(wq, 0, 64), _pad_nodes(s, 0, 64))
    assert got.dtype == getattr(torch, want_dtype) and got.shape == (N, b, ki)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if want_dtype == "float32":  # the same exact products summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        _assert_within_one_bf16_step(got, want, 2.0 ** -7 if want_dtype == "bfloat16" else 2.0 ** -10)


@pytest.mark.parametrize("transposed", [False, True])
def test_q8_wrappers_take_any_contraction_and_refuse_only_int_overflow(transposed):
    """The kernels stream the contraction through a ring: a long one (the
    old kernels' shared memory held at most 1,210) runs on the CPU's plain
    version as on the card; the refusal is a dimension past the kernel's
    int arguments, with its message."""
    g = torch.Generator().manual_seed(3)
    ki, o = (8, 4096) if transposed else (4096, 8)
    wq, s = quantize_node_weights(torch.randn(2, ki, o, generator=g))
    act = torch.randn(2, 3, o if transposed else ki, generator=g).to(torch.bfloat16)
    fn, plain = (node_apply_q8_t, node_apply_q8_t_plain) if transposed else (node_apply_q8, node_apply_q8_plain)
    assert torch.equal(fn(act, wq, s), plain(act, wq, s))
    # N, B, KI and O each at most 2^31 - 1 (B here)
    big = 2 ** 31
    w_shape = (1, 8, 8)
    with pytest.raises(ValueError, match=r"N, B, KI and O of at most 2147483647 .* got 1, {}, 8, 8".format(big)):
        fn(torch.zeros(1, big, 8, dtype=torch.bfloat16, device="meta"),
           torch.zeros(w_shape, dtype=torch.int8, device="meta"), torch.ones(1, 1, 8, device="meta"))


@pytest.mark.parametrize("kind", sorted(node_apply.Q8_FAULTS))
def test_q8_planted_faults_are_scoped_and_leave_the_cpu_path_alone(kind):
    """A fault planted in B2's or B2t's kernel holds only inside its block,
    only for its kernel, and makes CPU tensors raise (the plain versions
    carry no fault) instead of passing a check unfaulted."""
    hh = torch.randn(N, B, KI).to(torch.bfloat16)
    dpre = torch.randn(N, B, O).to(torch.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()))
    calls = {"node_apply_q8": lambda: node_apply_q8(hh, wq, s), "node_apply_q8_t": lambda: node_apply_q8_t(dpre, wq, s)}
    target, code = node_apply.Q8_FAULTS[kind]
    with pytest.raises(KeyError):
        with node_apply.planted_q8_fault("no such fault"):
            pass
    with node_apply.planted_q8_fault(kind):
        assert node_apply._q8_planted == {target: code}
        with pytest.raises(RuntimeError, match="planted fault"):
            calls[target]()
        other = next(name for name in calls if name != target)
        calls[other]()
    assert node_apply._q8_planted == {}
    assert torch.equal(calls[target](), (node_apply_q8_plain(hh, wq, s) if target == "node_apply_q8"
                                         else node_apply_q8_t_plain(dpre, wq, s)))


@pytest.mark.parametrize("ki,o,transposed,want", [
    (320, 128, False, "weights TMA, activations TMA"),
    (60, 128, False, "weights TMA, activations element loads"),
    (320, 40, False, "weights element loads, activations TMA"),
    (60, 40, True, "weights element loads, activations TMA"),
    (320, 20, True, "weights element loads, activations element loads"),
    (60, 64, True, "weights TMA, activations TMA"),
])
def test_q8_load_path_follows_the_rows(ki, o, transposed, want):
    """TMA takes rows of whole 16-byte units: the int8 weights' rows of O
    bytes, the activation's rows of KI (B2) or O (B2t) bf16."""
    assert node_apply.q8_load_path(ki, o, transposed) == want


@pytest.mark.parametrize("ki,o,transposed,dtype,want", [
    (320, 128, False, torch.float32, "weights TMA, activations TMA"),
    (318, 128, False, torch.float32, "weights TMA, activations element loads"),
    (60, 40, True, torch.float32, "weights element loads, activations TMA"),
    (60, 20, True, torch.float32, "weights element loads, activations TMA"),
    (60, 20, True, torch.float16, "weights element loads, activations element loads"),
    (60, 64, False, torch.float16, "weights TMA, activations element loads"),
])
def test_q8_load_path_follows_the_rows_of_the_activation_dtype(ki, o, transposed, dtype, want):
    """The activation's rows take TMA where they are whole 16-byte units:
    KI or O % 4 == 0 in f32, % 8 == 0 in f16 (as in bf16)."""
    assert node_apply.q8_load_path(ki, o, transposed, dtype) == want


def test_layout_gradient_matches_the_jax_vjp_bit_for_bit():
    """The cotangent through force_default_layout of a strided view is the
    same copy as JAX's VJP (layout.py:56-64, interpret mode)."""
    jax = pytest.importorskip("jax")
    from multistgraph_tpu.ops.layout import force_default_layout as jax_layout

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 2, 5, 12)).astype(np.float32)
    g = rng.normal(size=(3, 2, 5, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_layout(a[..., 4:], True), x)
    (want,) = vjp(g)
    xt = torch.tensor(x, requires_grad=True)
    y = force_default_layout(xt[..., 4:])
    assert y.is_contiguous()
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


def test_layout_plain_is_a_bit_identical_contiguous_copy():
    x = torch.randn(3, 4, 5, 12)
    for view in (x[..., :8], x[..., 8:], x.transpose(1, 2), x):
        y = force_default_layout(view)
        assert y.is_contiguous() and y.data_ptr() != view.data_ptr()
        assert torch.equal(y, view)


def test_wrappers_reject_wrong_dtypes_and_layouts():
    hh = torch.zeros(N, B, KI, dtype=torch.bfloat16)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()))
    # f32 and f16 activations run (JAX's "any float"); f64 is refused
    with pytest.raises(TypeError):
        node_apply_q8(hh.double(), wq, s)
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq.float(), s)
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq, s.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        node_apply_q8(hh.transpose(0, 1).contiguous().transpose(0, 1), wq, s)
    with pytest.raises(ValueError, match="shape"):
        node_apply_q8(hh[:, :, :-1].contiguous(), wq, s)
    with pytest.raises(ValueError, match="rank"):
        force_default_layout(torch.zeros(1, 1, 1, 1, 1))
    for dtype in (torch.bfloat16, torch.int8, torch.float64):
        with pytest.raises(TypeError, match="4-byte"):
            force_default_layout(torch.zeros(2, 3, dtype=dtype))
    dpre = torch.zeros(N, B, O, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        node_apply_q8_t(dpre.double(), wq, s)
    with pytest.raises(ValueError, match="shape"):
        node_apply_q8_t(dpre[:, :, :-1].contiguous(), wq, s)
    with pytest.raises(ValueError, match="contiguous"):
        node_apply_q8_t(dpre.transpose(0, 1).contiguous().transpose(0, 1), wq, s)
    # the kernels stream any contraction; what they refuse is a dimension
    # past their int arguments
    with pytest.raises(ValueError, match="at most 2147483647"):
        node_apply_q8_t(torch.zeros(1, 1, 8, dtype=torch.bfloat16, device="meta"),
                        torch.zeros(1, 2 ** 31, 8, dtype=torch.int8, device="meta"),
                        torch.ones(1, 1, 8, device="meta"))
    # the layout copy's backward takes 4-byte cotangents only, as the forward
    # (autograd hands it the forward's dtype, f32 on the main path)
    from multistgraph_tpu_torch.ops.layout import _ForceDefaultLayout

    with pytest.raises(TypeError, match="4-byte"):
        _ForceDefaultLayout.backward(None, torch.zeros(2, 3, dtype=torch.bfloat16))


# ---------------------------------------------------------------- on the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,o", [(16, 128), (16, 64), (3, 40), (33, 16)])
def test_cuda_node_apply_matches_plain(cuda, b, o):
    g = torch.Generator().manual_seed(b * o)
    n, ki = 237, 320
    hh = torch.randn(n, b, ki, generator=g).to(torch.bfloat16).to(cuda)
    wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
    wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
    before = node_apply_q8.launches
    got = node_apply_q8(hh, wq, s)
    torch.cuda.synchronize()
    assert node_apply_q8.launches == before + 1
    want = node_apply_q8_plain(hh, wq, s)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 256])
def test_cuda_node_apply_takes_any_batch(cuda, b):
    """B=256 was refused before the kernel walked the batch in tiles."""
    g = torch.Generator().manual_seed(b)
    n, ki = 237, 320
    for o in (128, 64):
        hh = torch.randn(n, b, ki, generator=g).to(torch.bfloat16).to(cuda)
        wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
        wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
        got = node_apply_q8(hh, wq, s)
        want = node_apply_q8_plain(hh, wq, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,o", [(16, 128), (16, 64), (1, 128), (256, 64), (33, 40)])
def test_cuda_transposed_node_apply_matches_plain(cuda, b, o):
    g = torch.Generator().manual_seed(b * o + 1)
    n, ki = 237, 320
    dpre = torch.randn(n, b, o, generator=g).to(torch.bfloat16).to(cuda)
    wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g).to(cuda))
    wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
    before = node_apply_q8_t.launches
    got = node_apply_q8_t(dpre, wq, s)
    torch.cuda.synchronize()
    assert node_apply_q8_t.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, b, ki)
    _assert_within_one_bf16_step(got.float().cpu().numpy(),
                                 node_apply_q8_t_plain(dpre, wq, s).float().cpu().numpy())


@pytest.mark.cuda
def test_cuda_layout_copy_backward_matches_plain(cuda):
    x = torch.randn(6, 5, 37, 192, device=cuda, requires_grad=True)
    cot = torch.randn(6, 5, 37, 128, device=cuda)
    before = (force_default_layout.launches, force_default_layout.backward_launches)
    y = force_default_layout(x[..., :128])
    y.backward(cot)
    torch.cuda.synchronize()
    assert (force_default_layout.launches, force_default_layout.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad[..., :128], force_default_layout_plain(cot))
    assert not x.grad[..., 128:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_layout_copy_matches_plain(cuda, dtype):
    x = (torch.randn(6, 5, 37, 192, device=cuda) * 50).to(dtype)
    before = force_default_layout.launches
    # vector-load views (the first two, as on the main path) and gather views
    for view in (x[..., :128], x[..., 128:], x.transpose(1, 2), x[:, :, 1:, 3:100], x[0]):
        y = force_default_layout(view)
        assert y.is_contiguous()
        assert torch.equal(y, force_default_layout_plain(view))
    torch.cuda.synchronize()
    assert force_default_layout.launches == before + 5


@pytest.mark.cuda
def test_cuda_wrappers_reject_wrong_dtypes(cuda):
    # the kernels take bf16, f32 and f16 activations; f64 raises, with no
    # fall back to the plain version
    hh = torch.zeros(N, B, KI, dtype=torch.float64, device=cuda)
    wq, s = quantize_node_weights(torch.from_numpy(_weights()).to(cuda))
    with pytest.raises(TypeError):
        node_apply_q8(hh, wq, s)
    with pytest.raises(TypeError):
        node_apply_q8_t(torch.zeros(N, B, O, dtype=torch.float64, device=cuda), wq, s)
    with pytest.raises(TypeError, match="4-byte"):
        force_default_layout(hh.half())


# ---------------------------------------------------------------- B2 and B2t on the tensor cores

BATCHES = [1, 3, 4, 8, 15, 16, 17, 33, 64, 256]
TILES = [8, 16, 24, 32, 64, 128]
WIDE = [torch.float32, torch.float16]   # the activation dtypes besides bf16
WIDE_IDS = ["f32", "f16"]


def _q8_operands(cuda, seed, b, ki, o, transposed, n=237, nw=256, dtype=torch.bfloat16):
    """The activation (hh, or B2t's dpre) of `dtype` and int8 weights and
    scales of n nodes, padded to nw weight rows, drawn on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    act = torch.randn(n, b, o if transposed else ki, generator=g, device=cuda).to(dtype)
    wq, s = quantize_node_weights(torch.randn(n, ki, o, generator=g, device=cuda))
    return act, _pad_nodes(wq, 0, nw), _pad_nodes(s, 0, nw)


def _q8_fns(transposed):
    return (node_apply_q8_t, node_apply_q8_t_plain) if transposed else (node_apply_q8, node_apply_q8_plain)


def _q8_holds(got, want):
    """By the result's dtype: f32 (B2, and B2t where it writes f32) rtol
    1e-5, atol 1e-5 max|plain| (the same exact products summed in another
    order); bf16 and f16 (B2t) one step of the dtype, which a sum in
    another order can move its rounding by."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    step = {torch.float32: None, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}[want.dtype]
    got, want = got.float(), want.float()
    if step is None:
        bound = 1e-5 * (want.abs() + want.abs().max())
    else:
        bound = step * (want.abs() + 1e-3 * want.abs().max())
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
@pytest.mark.parametrize("ki", [80, 320])
@pytest.mark.parametrize("o", [16, 40, 64, 128])
@pytest.mark.parametrize("b", BATCHES)
def test_cuda_q8_kernels_match_plain_at_every_batch(cuda, b, o, ki, transposed):
    act, wq, s = _q8_operands(cuda, b * 1000 + o + ki, b, ki, o, transposed)
    fn, plain = _q8_fns(transposed)
    got = fn(act, wq, s)
    torch.cuda.synchronize()
    assert got.shape == (237, b, ki if transposed else o)
    assert _q8_holds(got, plain(act, wq, s))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
@pytest.mark.parametrize("ki,o", [(60, 64), (80, 20), (60, 40), (20, 8), (100, 16), (20, 48)])
def test_cuda_q8_element_loads_match_plain(cuda, ki, o, transposed):
    """Shapes whose rows TMA cannot take (O % 16, KI or O % 8) load those
    operands element by element, into the same layout."""
    fn, plain = _q8_fns(transposed)
    for b in (4, 16, 40):
        act, wq, s = _q8_operands(cuda, b + ki + o, b, ki, o, transposed)
        got = fn(act, wq, s)
        torch.cuda.synchronize()
        assert _q8_holds(got, plain(act, wq, s)), (b, node_apply.q8_load_path(ki, o, transposed))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
def test_cuda_q8_offset_views_run_right_or_raise(cuda, transposed):
    """An offset slice of whole nodes stays 16-byte aligned and runs; a view
    that starts off a 16-byte boundary runs where its rows take element
    loads and raises where they take TMA (the wrapper's documented rule)."""
    fn, plain = _q8_fns(transposed)
    n, b = 37, 16
    for ki, o, tma in ((320, 64, True), (60, 20, False)):
        act, wq, s = _q8_operands(cuda, ki + o, b, ki, o, transposed, n=n + 1, nw=n + 1)
        got = fn(act[1:], wq[1:], s[1:])
        torch.cuda.synchronize()
        assert _q8_holds(got, plain(act[1:], wq[1:], s[1:]))
        flat = torch.empty(act[1:].numel() + 1, dtype=act.dtype, device=cuda)
        act_off = flat[1:].view(act[1:].shape)
        act_off.copy_(act[1:])
        wflat = torch.empty(wq[1:].numel() + 1, dtype=wq.dtype, device=cuda)
        wq_off = wflat[1:].view(wq[1:].shape)
        wq_off.copy_(wq[1:])
        for a, w in ((act_off, wq[1:]), (act[1:], wq_off)):
            if tma:
                with pytest.raises(RuntimeError, match="launch failed"):
                    fn(a, w, s[1:])
            else:
                got = fn(a, w, s[1:])
                torch.cuda.synchronize()
                assert _q8_holds(got, plain(act[1:], wq[1:], s[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(node_apply.Q8_FAULTS))
@pytest.mark.parametrize("b", [16, 256])
def test_cuda_q8_planted_faults_fail_the_check(cuda, kind, b):
    """Each fault planted in B2's or B2t's kernel (the last k16 slice of the
    contraction dropped; B2's batch columns past the first 8 zeroed) fails
    the check the unfaulted kernel passes."""
    target, _ = node_apply.Q8_FAULTS[kind]
    transposed = target == "node_apply_q8_t"
    fn, plain = _q8_fns(transposed)
    act, wq, s = _q8_operands(cuda, b + 7, b, 320, 128, transposed)
    want = plain(act, wq, s)
    with node_apply.planted_q8_fault(kind):
        bad = fn(act, wq, s)
    good = fn(act, wq, s)
    torch.cuda.synchronize()
    assert _q8_holds(good, want)
    assert not _q8_holds(bad, want)


@pytest.mark.cuda
def test_cuda_q8_batch_tile_is_the_narrowest_that_holds_the_batch_up_to_128(cuda):
    batches = (1, 4, 8, 9, 16, 17, 33, 64, 65, 129, 256, 300)
    assert [node_apply.q8_batch_tile(b) for b in batches] == [8, 8, 8, 16, 16, 24, 64, 64, 128, 128, 128, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
def test_cuda_q8_batch_tile_of_f32_and_f16_activations_stops_at_64(cuda, dtype):
    """Their pieces leave room for one 128-column block an SM, so wide
    batches take tiles of 64."""
    batches = (1, 4, 8, 9, 16, 17, 33, 64, 65, 129, 256, 300)
    assert [node_apply.q8_batch_tile(b, dtype) for b in batches] == [8, 8, 8, 16, 16, 24, 64, 64, 64, 64, 64, 64]


def _launch_tile(cuda, transposed, act, wq, s, tile):
    """B2 or B2t at batch tile `tile`."""
    n, b, _ = act.shape
    _, ki, o = wq.shape
    out = torch.empty(n, b, ki if transposed else o, dtype=act.dtype if transposed else torch.float32,
                      device=cuda)
    name, entry = (("node_apply_q8_t", "node_apply_q8_t_bwd_typed") if transposed
                   else ("node_apply_q8", "node_apply_q8_fwd_typed"))
    code = node_apply._Q8_TYPES[act.dtype]
    node_apply._launch_entry(name, entry, (act.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr()),
                             (n, b, ki, o, tile, 0, code), cuda)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tile", TILES)
def test_cuda_q8_every_batch_tile_matches_plain(cuda, tile):
    """Each batch tile, at a batch of 33 (five tiles of 8, one of 64)."""
    for transposed in (False, True):
        act, wq, s = _q8_operands(cuda, tile, 33, 320, 128, transposed)
        got = _launch_tile(cuda, transposed, act, wq, s, tile)
        torch.cuda.synchronize()
        assert _q8_holds(got, _q8_fns(transposed)[1](act, wq, s))


@pytest.mark.cuda
def test_cuda_q8_blocks_walk_batch_tiles_past_the_grid(cuda):
    """More work items (batch tiles of 8) than a grid dimension's 65,535:
    the persistent blocks walk them all."""
    b = 8 * 65535 + 9
    for transposed in (False, True):
        act, wq, s = _q8_operands(cuda, 5, b, 16, 16, transposed, n=1, nw=1)
        got = _launch_tile(cuda, transposed, act, wq, s, 8)
        torch.cuda.synchronize()
        assert _q8_holds(got, _q8_fns(transposed)[1](act, wq, s))


@pytest.mark.cuda
def test_cuda_q8_empty_contraction_writes_zeros(cuda):
    hh = torch.zeros(5, 3, 0, dtype=torch.bfloat16, device=cuda)
    got = node_apply_q8(hh, torch.zeros(8, 0, 16, dtype=torch.int8, device=cuda), torch.ones(8, 1, 16, device=cuda))
    dpre = torch.zeros(5, 3, 0, dtype=torch.bfloat16, device=cuda)
    got_t = node_apply_q8_t(dpre, torch.zeros(8, 24, 0, dtype=torch.int8, device=cuda), torch.ones(8, 1, 0, device=cuda))
    torch.cuda.synchronize()
    assert got.shape == (5, 3, 16) and not got.any()
    assert got_t.shape == (5, 3, 24) and not got_t.any()


# ---------------------------------------------------------------- B2 and B2t on f32 and f16 activations

@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize("o", [64, 128])
@pytest.mark.parametrize("b", BATCHES)
def test_cuda_q8_f32_and_f16_forms_match_plain_at_every_batch(cuda, b, o, dtype, transposed):
    """Each launch counts in its dtype's counter only."""
    act, wq, s = _q8_operands(cuda, b * 1000 + o + 7, b, 320, o, transposed, dtype=dtype)
    fn, plain = _q8_fns(transposed)
    counter = node_apply._Q8_COUNTERS[dtype]
    before = {c: getattr(fn, c) for c in node_apply._Q8_COUNTERS.values()}
    got = fn(act, wq, s)
    torch.cuda.synchronize()
    after = {c: getattr(fn, c) for c in node_apply._Q8_COUNTERS.values()}
    assert after == dict(before, **{counter: before[counter] + 1})
    assert got.dtype == (dtype if transposed else torch.float32)
    assert _q8_holds(got, plain(act, wq, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize("tile", TILES)
def test_cuda_q8_f32_and_f16_forms_at_every_batch_tile_match_plain(cuda, tile, dtype):
    """Each batch tile, at a batch of 33 (five tiles of 8, one of 64)."""
    for transposed in (False, True):
        act, wq, s = _q8_operands(cuda, tile + 11, 33, 320, 128, transposed, dtype=dtype)
        got = _launch_tile(cuda, transposed, act, wq, s, tile)
        torch.cuda.synchronize()
        assert _q8_holds(got, _q8_fns(transposed)[1](act, wq, s)), (tile, transposed)


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize("ki,o", [(62, 64), (30, 20), (60, 18), (80, 6), (21, 11), (318, 128)])
def test_cuda_q8_f32_and_f16_element_loads_match_plain(cuda, ki, o, dtype, transposed):
    """Rows TMA cannot take (the activation's rows of KI or O no whole
    16-byte units: % 4 in f32, % 8 in f16; the weights' O % 16) load
    element by element, into the same layout."""
    fn, plain = _q8_fns(transposed)
    for b in (4, 16, 40):
        act, wq, s = _q8_operands(cuda, b + ki + o, b, ki, o, transposed, dtype=dtype)
        got = fn(act, wq, s)
        torch.cuda.synchronize()
        assert _q8_holds(got, plain(act, wq, s)), (b, node_apply.q8_load_path(ki, o, transposed, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True], ids=["B2", "B2t"])
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
def test_cuda_q8_f32_and_f16_offset_views_run_right_or_raise(cuda, dtype, transposed):
    """An offset slice of whole nodes runs; an activation that starts one
    element off a 16-byte boundary runs where its rows take element loads
    and raises where they take TMA."""
    fn, plain = _q8_fns(transposed)
    n, b = 37, 16
    for ki, o in ((320, 64), (62, 18)):
        act, wq, s = _q8_operands(cuda, ki + o, b, ki, o, transposed, n=n + 1, nw=n + 1, dtype=dtype)
        want = plain(act[1:], wq[1:], s[1:])
        got = fn(act[1:], wq[1:], s[1:])
        torch.cuda.synchronize()
        assert _q8_holds(got, want)
        flat = torch.empty(act[1:].numel() + 1, dtype=dtype, device=cuda)
        act_off = flat[1:].view(act[1:].shape)
        act_off.copy_(act[1:])
        if "activations TMA" in node_apply.q8_load_path(ki, o, transposed, dtype):
            with pytest.raises(RuntimeError, match="launch failed"):
                fn(act_off, wq[1:], s[1:])
        else:
            got = fn(act_off, wq[1:], s[1:])
            torch.cuda.synchronize()
            assert _q8_holds(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
@pytest.mark.parametrize("kind", sorted(node_apply.Q8_FAULTS))
@pytest.mark.parametrize("b", [16, 256])
def test_cuda_q8_f32_and_f16_planted_faults_fail_the_check(cuda, kind, b, dtype):
    """The faults planted in the f32 and f16 forms (in B2 the last k16
    slice dropped from every piece of x) fail the check the unfaulted
    kernel passes."""
    target, _ = node_apply.Q8_FAULTS[kind]
    transposed = target == "node_apply_q8_t"
    fn, plain = _q8_fns(transposed)
    act, wq, s = _q8_operands(cuda, b + 9, b, 320, 128, transposed, dtype=dtype)
    want = plain(act, wq, s)
    with node_apply.planted_q8_fault(kind):
        bad = fn(act, wq, s)
    good = fn(act, wq, s)
    torch.cuda.synchronize()
    assert _q8_holds(good, want)
    assert not _q8_holds(bad, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16] + WIDE, ids=["bf16"] + WIDE_IDS)
@pytest.mark.parametrize("b", [3, 16, 100])
def test_cuda_q8_t_writes_the_cotangent_dtype(cuda, b, dtype):
    """B2t writes the cotangent's dtype, at batches whose tiles store from
    the registers (3, 16) and through shared memory (100), and at a KI
    whose rows take element-wise stores (KI = 60)."""
    for ki, o in ((320, 128), (60, 64)):
        act, wq, s = _q8_operands(cuda, b + ki, b, ki, o, True, dtype=dtype)
        got = node_apply_q8_t(act, wq, s)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (237, b, ki)
        assert _q8_holds(got, node_apply_q8_t_plain(act, wq, s))


@pytest.mark.cuda
def test_cuda_q8_f32_is_not_rounded_to_bf16(cuda):
    """The f32 form contracts hh in full: rounding hh to bf16 first gives
    another result, outside the f32 hold."""
    act, wq, s = _q8_operands(cuda, 5, 16, 320, 128, False, dtype=torch.float32)
    want = node_apply_q8_plain(act, wq, s)
    assert _q8_holds(node_apply_q8(act, wq, s), want)
    assert not _q8_holds(node_apply_q8(act.to(torch.bfloat16), wq, s), want)
