"""The port's band, hub and tail graph forms and products against the JAX
package: the split builders, both band packings, the band products (planes
and packed rows, forward, dV and dX) and the hub and tail products, values
and gradients, on the same numpy-seeded inputs.

JAX's band path runs on its default einsum dispatch; the kernel-level
tests run its Pallas kernels in interpret mode (``band_fwd_pallas``,
``band_dv_pallas``, ``band_dx_pallas``, ``band_fwd_slab_pallas``, and
``MSG_BAND_PALLAS=interpret`` set on the JAX side only for the dispatch
through ``spmm_band``), as tests/test_spmm_band.py runs them. N = 1000
nodes (8 row blocks of 128). Tolerances, each with its reason:
  * graph builders and packings: exact (the same numpy streams and the
    same np.add.at order);
  * band products: rtol = atol = 2e-4, as JAX's own band tests hold them
    (f32 products of 128-long dots summed in another order);
  * hub and tail products: rtol 1e-5 with atol 1e-6 times the reference's
    max |value| (a few f32 terms per row, summed in another order).
The CUDA kernels (csrc/band_spmm.cu) run only on the card:
tests/test_torch_port_band_cuda.py holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multistgraph_tpu.ops import band as jax_band
from multistgraph_tpu.ops import bsr as jax_bsr
from multistgraph_tpu.ops import hybrid as jax_hybrid
from multistgraph_tpu.ops import spmm as jax_spmm
from multistgraph_tpu_torch.ops import band, bsr, hybrid

N = 1000
BLOCK = 128
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(t):
    return t.detach().numpy()


def _edges(seed=0, num_edges=9000, lo=-200, hi=200, noise_frac=0.1):
    """tests/test_spmm_band.py's band-shaped edges (dst - src in [lo, hi]),
    with noise off the band."""
    rng = np.random.default_rng(seed)
    n_local = int(num_edges * (1 - noise_frac))
    src_l = rng.integers(0, N, n_local)
    dst_l = np.clip(src_l + rng.integers(lo, hi + 1, n_local), 0, N - 1)
    src = np.concatenate([src_l, rng.integers(0, N, num_edges - n_local)])
    dst = np.concatenate([dst_l, rng.integers(0, N, num_edges - n_local)])
    return src, dst, rng.uniform(0.1, 1.0, num_edges).astype(np.float32)


@pytest.fixture(scope="module")
def graph():
    """A lopsided band: offsets -3..1, so the packed rows hold absent slots."""
    g = band.split_band(*_edges(noise_frac=0.0, lo=-300, hi=120), N, BLOCK, min_fill_frac=0.5)
    offs = tuple(int(o) for o in g.offsets)
    assert offs[0] < 0 < offs[-1] and 0 in offs and band.band_radius(offs) not in offs
    return g


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_close(got, want, what="", **tol):
    got = _np(got) if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **(tol or TOL))


# ------------------------------------------------------------- builders
def _same_bsr(got, want):
    for name in ("values", "row_of", "col_of"):
        _same(getattr(got, name), getattr(want, name), name)


def _same_split(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, band.BandGraph):
        for name in ("band_values", "offsets", "rest_src", "rest_dst", "rest_w"):
            _same(getattr(got, name), getattr(want, name), name)
    else:
        _same_bsr(got.bsr, want.bsr)
        names = ("hub_cols", "hub_values") if isinstance(got, hybrid.HybridGraph) else (
            "tail_src", "tail_dst", "tail_w")
        for name in names:
            _same(getattr(got, name), getattr(want, name), name)
    assert (got.padded_nodes, got.block, got.nnz_edges) == (want.padded_nodes, want.block, want.nnz_edges)


@pytest.mark.parametrize("split", ["hub", "tail", "band"])
def test_random_spatial_graph_split_forms_equal_jax(split):
    got, edges = bsr.random_spatial_graph(N, 16, seed=3, split=split)
    want, want_edges = jax_bsr.random_spatial_graph(N, 16, seed=3, split=split)
    assert edges == want_edges
    _same_split(got, want)


def test_split_builders_equal_jax_on_their_options():
    src, dst, w = _edges(seed=1)
    src[:3], dst[:3] = 7, 9  # duplicate edges accumulate
    _same_split(band.split_band(src, dst, w, N, BLOCK, max_offsets=3, min_fill_frac=0.1),
                jax_band.split_band(src, dst, w, N, BLOCK, max_offsets=3, min_fill_frac=0.1))
    _same_split(hybrid.split_hub_columns(src, dst, w, N, BLOCK, max_hubs=4, min_row_blocks=1),
                jax_hybrid.split_hub_columns(src, dst, w, N, BLOCK, max_hubs=4, min_row_blocks=1))
    _same_split(hybrid.split_scattered_tail(src, dst, w, N, BLOCK, min_fill=40),
                jax_hybrid.split_scattered_tail(src, dst, w, N, BLOCK, min_fill=40))
    # no column clears the bar: the remainder is every edge
    none = hybrid.split_hub_columns(src, dst, w, N, BLOCK, min_row_blocks=N)
    _same_split(none, jax_hybrid.split_hub_columns(src, dst, w, N, BLOCK, min_row_blocks=N))
    assert none.num_hubs == 0 and none.hub_values.shape == (1024, 0)


def test_band_packings_equal_jax(graph):
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    for fn in ("pack_band_rows", "pack_band_rows_transposed"):
        got = getattr(band, fn)(graph.band_values, offs, radius)
        _same(got, getattr(jax_band, fn)(graph.band_values, offs, radius), fn)
        assert got.shape == (8, BLOCK, (2 * radius + 1) * BLOCK)


# ------------------------------------------------------------- band products
def _x_dy(feat, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1024, feat)).astype(np.float32), rng.normal(size=(1024, feat)).astype(np.float32))


def _port_vjp(fn, values, x, dy):
    v, xx = _t(values).requires_grad_(), _t(x).requires_grad_()
    y = fn(v, xx)
    y.backward(_t(dy))
    return y, v.grad, xx.grad


@pytest.mark.parametrize("feat", [3, 24])
def test_spmm_band_values_and_gradients_match_jax(graph, feat):
    x, dy = _x_dy(feat)
    want, vjp = jax.vjp(lambda v, xx: jax_band.spmm_band(v, graph.offsets, xx, block=BLOCK),
                        jnp.asarray(graph.band_values), jnp.asarray(x))
    want_dv, want_dx = vjp(jnp.asarray(dy))
    y, dv, dx = _port_vjp(lambda v, xx: band.spmm_band(v, graph.offsets, xx), graph.band_values, x, dy)
    _assert_close(y, want, "y")
    _assert_close(dx, want_dx, "dx")
    _assert_close(dv, want_dv, "dv")
    # dV tiles of an out-of-range row r + o stay zero, as JAX's padded x gives
    nb = graph.num_row_blocks
    for i, o in enumerate(graph.offsets):
        outside = [r for r in range(nb) if not 0 <= r + o < nb]
        assert not dv[i, outside].any()


def test_spmm_band_packed_values_and_gradients_match_jax(graph):
    x, dy = _x_dy(16, seed=3)
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    v_pack = band.pack_band_rows(graph.band_values, offs, radius)
    want, vjp = jax.vjp(lambda v, xx: jax_band.spmm_band_packed(v, radius, xx, block=BLOCK),
                        jnp.asarray(v_pack), jnp.asarray(x))
    want_dv, want_dx = vjp(jnp.asarray(dy))
    y, dv, dx = _port_vjp(lambda v, xx: band.spmm_band_packed(v, radius, xx), v_pack, x, dy)
    _assert_close(y, want, "y")
    _assert_close(dx, want_dx, "dx")
    _assert_close(dv, want_dv, "dv")
    # the packed form is the same operator as the planes
    _assert_close(y, band.spmm_band(_t(graph.band_values), offs, _t(x)), "packed vs planes")


def test_plain_versions_match_the_jax_pallas_kernels(graph):
    """Each kernel's plain version against the JAX Pallas kernel it replaces,
    in interpret mode: B7 forward, B9 dV and dX, B8 slab forward."""
    x, dy = _x_dy(8, seed=4)
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    nb = graph.num_row_blocks
    v = jnp.asarray(graph.band_values)
    xp = np.concatenate([np.zeros((radius, BLOCK, 8), np.float32), x.reshape(nb, BLOCK, 8),
                         np.zeros((radius, BLOCK, 8), np.float32)])
    dyb = jnp.asarray(dy.reshape(nb, BLOCK, 8))
    want_y = jax_band.band_fwd_pallas(v, jnp.asarray(xp), offs, radius, interpret=True)
    want_dv = jax_band.band_dv_pallas(dyb, jnp.asarray(xp), offs, radius, jnp.float32, interpret=True)
    want_dxp = jax_band.band_dx_pallas(v, dyb, offs, radius, jnp.float32, interpret=True)
    v_pack = band.pack_band_rows(graph.band_values, offs, radius)
    want_slab = jax_band.band_fwd_slab_pallas(jnp.asarray(v_pack), jnp.asarray(xp), radius, chunk_rows=3,
                                              interpret=True)
    vt, xt, dyt = _t(graph.band_values), _t(x), _t(dy)
    _assert_close(band.band_spmm(vt, offs, xt).reshape(nb, BLOCK, 8), want_y, "B7")
    _assert_close(band.band_dv(dyt, xt, offs), want_dv, "B9 dV")
    _assert_close(band.band_dx(vt, offs, dyt).reshape(nb, BLOCK, 8), np.asarray(want_dxp)[radius:radius + nb],
                  "B9 dX")
    _assert_close(band.band_spmm_packed(_t(v_pack), radius, xt).reshape(nb, BLOCK, 8), want_slab, "B8")
    # the packed backward's dX and dV against the planes' (same operator)
    _assert_close(band.band_dx_packed(_t(v_pack), radius, dyt), band.band_dx(vt, offs, dyt), "packed dX")
    dv_pack = band.band_dv_packed(dyt, xt, radius).reshape(nb, BLOCK, 2 * radius + 1, BLOCK)
    for i, o in enumerate(offs):
        _assert_close(dv_pack[:, :, o + radius], _np(band.band_dv(dyt, xt, offs)[i]), "packed dV")


def test_spmm_band_matches_the_jax_pallas_dispatch(graph, monkeypatch):
    """MSG_BAND_PALLAS=interpret on the JAX side routes spmm_band's forward
    and both VJP legs through the Pallas kernels; the port's Function
    matches them."""
    x, dy = _x_dy(8, seed=5)
    monkeypatch.setenv("MSG_BAND_PALLAS", "interpret")
    want, vjp = jax.vjp(lambda v, xx: jax_band.spmm_band(v, graph.offsets, xx, block=BLOCK),
                        jnp.asarray(graph.band_values), jnp.asarray(x))
    want_dv, want_dx = vjp(jnp.asarray(dy))
    monkeypatch.delenv("MSG_BAND_PALLAS")
    y, dv, dx = _port_vjp(lambda v, xx: band.spmm_band(v, graph.offsets, xx), graph.band_values, x, dy)
    _assert_close(y, want, "y")
    _assert_close(dx, want_dx, "dx")
    _assert_close(dv, want_dv, "dv")


def test_band_functions_call_only_the_wrappers_and_skip_unneeded_terms(graph):
    """spmm_band and spmm_band_packed reach the band wrappers, whose CUDA
    branch launches the kernels: forward B7 or B8, backward B9 dX only for an
    input that needs it and B9 dV only for values that need it. On CPU
    tensors the wrappers take their plain versions and count no launch."""
    offs = tuple(int(o) for o in graph.offsets)
    radius = band.band_radius(offs)
    v, v_pack = _t(graph.band_values), _t(band.pack_band_rows(graph.band_values, offs, radius))
    x, dy = (_t(a) for a in _x_dy(4))
    names = ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed", "band_dv", "band_dv_packed")
    calls = dict.fromkeys(names, 0)
    launches = {n: getattr(band, n).launches for n in names}

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            mp.setattr(band, name, count(name, getattr(band, name)))
        band.spmm_band(v, offs, x.clone().requires_grad_()).backward(dy)  # the model's static band
        assert calls == dict(calls, band_spmm=1, band_dx=1, band_dv=0)
        band.spmm_band(v.clone().requires_grad_(), offs, x).backward(dy)
        assert calls == dict(calls, band_spmm=2, band_dx=1, band_dv=1)
        band.spmm_band_packed(v_pack, radius, x.clone().requires_grad_()).backward(dy)
        band.spmm_band_packed(v_pack.clone().requires_grad_(), radius, x).backward(dy)
        with torch.no_grad():
            band.spmm_band_packed(v_pack, radius, x.clone().requires_grad_())
        assert calls == {"band_spmm": 2, "band_spmm_packed": 3, "band_dx": 1, "band_dx_packed": 1,
                         "band_dv": 1, "band_dv_packed": 1}
    assert {n: getattr(band, n).launches for n in names} == launches


def test_band_wrappers_reject_what_the_kernels_do_not_take(graph):
    v = _t(graph.band_values)
    offs = tuple(int(o) for o in graph.offsets)
    with pytest.raises(TypeError, match="float32"):
        band.band_spmm(v.double(), offs, torch.zeros(1024, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape mismatch"):
        band.band_spmm(v, offs[:-1], torch.zeros(1024, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        band.band_spmm(v, offs, torch.zeros(896, 4))
    with pytest.raises(ValueError, match="contiguous"):
        band.band_dx(v, offs, torch.zeros(4, 1024).t())
    with pytest.raises(ValueError, match="shape mismatch"):
        band.band_spmm_packed(v[0], 1, torch.zeros(1024, 4))
    assert not band.spmm_band(v[:0], (), torch.ones(1024, 4)).any()  # no diagonal: zeros, as JAX


@pytest.mark.parametrize("feat, path", [(1, "element loads"), (8, "TMA"), (12, "element loads"), (24, "TMA"),
                                        (136, "TMA")])
def test_bf16_kernels_take_x_by_tma_only_in_whole_16_byte_rows(feat, path):
    assert band.bf16_load_path(feat) == path


@pytest.mark.parametrize("feat, aligned, path", [
    (1, True, "one bulk copy a chunk"), (3, True, "one bulk copy a chunk"), (12, True, "one bulk copy a chunk"),
    (31, True, "one bulk copy a chunk"), (12, False, "element loads"), (17, False, "element loads"),
    (33, True, "element loads"), (300, True, "element loads"), (8, False, "TMA"), (24, True, "TMA"),
    (1536, True, "TMA")])
def test_forward_and_dx_take_narrow_x_by_one_bulk_copy_where_aligned(feat, aligned, path):
    """B7, B8 and B9 dX: x by TMA in whole 16-byte rows (an unaligned x then
    fails to encode and raises); below 32 columns each chunk's 64 contiguous
    rows by one bulk copy where x is 16-byte aligned; else element by element."""
    assert band.x_load_path(feat, aligned) == path
    assert band.SPAN_MAX_F == 32


def test_planted_faults_are_scoped_and_leave_the_cpu_path_alone(graph):
    """A planted fault reaches only the kernels' fault entries for the calls
    inside its block; CPU tensors take the plain version all the same."""
    v = _t(graph.band_values)
    offs = tuple(int(o) for o in graph.offsets)
    x = torch.ones(1024, 4)
    want = band.band_spmm(v, offs, x)
    with pytest.raises(KeyError):
        with band.planted_fault("no such fault"):
            pass
    for kind in sorted(band.FAULTS):
        with band.planted_fault(kind):
            assert band._planted == band.FAULTS[kind]
            torch.testing.assert_close(band.band_spmm(v, offs, x), want, rtol=0, atol=0)
        assert band._planted == 0


# ------------------------------------------------------------- hub and tail
def _hy_inputs(seed):
    src, dst, w = _edges(seed=seed, noise_frac=0.3)
    rng = np.random.default_rng(seed + 10)
    dst[: 600] = rng.choice([5, 300, 777], 600)  # three hub columns
    x = rng.normal(size=(1024, 6)).astype(np.float32)
    dy = rng.normal(size=(1024, 6)).astype(np.float32)
    return src, dst, w, x, dy


def _hy_close(got, want, what):
    want = np.asarray(want)
    _assert_close(got, want, what, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("form", ["hub", "tail"])
def test_hybrid_products_values_and_gradients_match_jax(form):
    src, dst, w, x, dy = _hy_inputs(seed={"hub": 7, "tail": 8}[form])
    kernel = lambda v, r, c, xx: jax_spmm.spmm_jax(v, r, c, xx, block=BLOCK)  # noqa: E731
    if form == "hub":
        g = hybrid.split_hub_columns(src, dst, w, N, BLOCK, min_row_blocks=1)
        assert g.num_hubs >= 3 and g.bsr.nnz_blocks > 0
        extra, names = (g.hub_values, g.hub_cols), ("hub_values",)
        jfn = lambda v, e, xx: jax_hybrid.spmm_hybrid(v, g.bsr.row_of, g.bsr.col_of, e, g.hub_cols, xx,  # noqa
                                                      kernel=kernel)
        tfn = lambda v, e, xx: hybrid.spmm_hybrid(v, _t(g.bsr.row_of), _t(g.bsr.col_of), e, _t(g.hub_cols), xx)  # noqa
    else:
        g = hybrid.split_scattered_tail(src, dst, w, N, BLOCK, min_fill=40)
        assert g.num_tail_edges > 0 and g.bsr.nnz_blocks > 0
        extra, names = (g.tail_w,), ("tail_w",)
        jfn = lambda v, e, xx: jax_hybrid.spmm_tail_hybrid(v, g.bsr.row_of, g.bsr.col_of, e, g.tail_src,  # noqa
                                                           g.tail_dst, xx, kernel=kernel)
        tfn = lambda v, e, xx: hybrid.spmm_tail_hybrid(v, _t(g.bsr.row_of), _t(g.bsr.col_of), e,  # noqa
                                                       _t(g.tail_src), _t(g.tail_dst), xx)
    want, vjp = jax.vjp(jfn, jnp.asarray(g.bsr.values), jnp.asarray(extra[0]), jnp.asarray(x))
    want_dv, want_de, want_dx = vjp(jnp.asarray(dy))
    v, e, xx = (_t(a).requires_grad_() for a in (g.bsr.values, extra[0], x))
    y = tfn(v, e, xx)
    y.backward(_t(dy))
    _hy_close(y, want, "y")
    _hy_close(v.grad, want_dv, "dvalues")
    _hy_close(e.grad, want_de, "d" + names[0])
    _hy_close(xx.grad, want_dx, "dx")


def test_spmm_tail_alone_matches_jax_segment_sum():
    src, dst, w, x, dy = _hy_inputs(seed=9)
    g = hybrid.split_scattered_tail(src, dst, w, N, BLOCK)
    want, vjp = jax.vjp(lambda e, xx: jax_hybrid.spmm_tail(e, g.tail_src, g.tail_dst, xx, 1024),
                        jnp.asarray(g.tail_w), jnp.asarray(x))
    want_de, want_dx = vjp(jnp.asarray(dy))
    e, xx = _t(g.tail_w).requires_grad_(), _t(x).requires_grad_()
    y = hybrid.spmm_tail(e, _t(g.tail_src), _t(g.tail_dst), xx, 1024)
    y.backward(_t(dy))
    _hy_close(y, want, "y")
    _hy_close(e.grad, want_de, "dtail_w")
    _hy_close(xx.grad, want_dx, "dx")
