"""The f16 forms of the sparse kernels on the card: B4/B6 (``bsr_spmm``,
csrc/bsr_spmm.cu), B5 (``sampled_matmul``, csrc/sampled_matmul.cu) and the
band kernels B7, B8, B9 dX and B9 dV (csrc/band_spmm.cu) with float16
operands on the tensor cores, each against its plain version at odd shapes
and on every load path (an operand by TMA where its width % 8 == 0, else
the SpMMs' x below 32 columns by one bulk copy a chunk where it is 16-byte
aligned, else by element loads; B4/B6 in bf16 too); the faults planted in
them; the f16 autograd terms on the card against the CPU (the SDDMM's
backward on the f32 SpMM); and one f16 SparseATGCN training step on the
BSR and band forms with exact launch counts on each dtype's counter.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_f16_cuda.py
Tolerances, each with its reason:
  * f32 outputs (bsr_spmm's sums, sampled_matmul's f32 tiles, dV into f32
    values): rtol 1e-5 with atol 1e-5 times max |plain| (products of two
    f16 values are exact in f32; the kernel and the plain version sum them
    in f32 in another order);
  * f16 outputs (the band forward, dX and dV, the f16 gradients): within
    one f16 step of the plain version, 2^-10 |plain| + 2^-10 * 1e-3
    max|plain| (the same f32 sums in another order, rounded once).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import band, bsr, spmm

BLOCK = 128
F16 = torch.float16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _card_graph(cuda, n_blocks, nnz, seed, empty_rows=(), full_row=None):
    """A random pattern of `nnz` tiles over n_blocks x n_blocks blocks (rows in
    `empty_rows` left out; with `full_row`, that row holds a tile in every
    column besides), f16 values, on the card."""
    rng = np.random.default_rng(seed)
    rows = [r for r in range(n_blocks) if r not in empty_rows]
    keys = rng.choice(len(rows) * n_blocks, size=nnz, replace=False)
    keys = np.asarray(rows, np.int64)[keys // n_blocks] * n_blocks + keys % n_blocks
    if full_row is not None:
        keys = np.union1d(keys, full_row * n_blocks + np.arange(n_blocks))
    keys = np.sort(keys)
    row, col = (keys // n_blocks).astype(np.int32), (keys % n_blocks).astype(np.int32)
    values = torch.from_numpy(rng.normal(size=(len(keys), BLOCK, BLOCK)).astype(np.float32)).to(cuda).to(F16)
    row_t = torch.from_numpy(row).to(cuda)
    return values, row_t, spmm.row_ptr_of(row_t, n_blocks), torch.from_numpy(col).to(cuda)


def _randn(cuda, *shape, seed=0, scale=1.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device=cuda) * scale).to(F16)


def _f32_ratio(got, want):
    """Largest |got - want| over rtol 1e-5 |want| + 1e-5 max|want|."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-5 * (want.abs() + want.abs().max())
    return ((got - want).abs() / bound).max().item()


def _f16_step_ratio(got, want):
    """Largest |got - want| over one f16 step of want."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == F16 and got.shape == want.shape
    got, want = got.float(), want.float()
    bound = 2.0 ** -10 * (want.abs() + 1e-3 * want.abs().max())
    diff = (got - want).abs()
    return (diff / bound).masked_fill(diff == 0, 0.0).max().item()


def _counts(*fns):
    return [(fn.launches, getattr(fn, "bf16_launches", 0), fn.f16_launches) for fn in fns]


# ------------------------------------------------------------ B4/B6 and B5
@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 12, 16, 17, 24, 64, 128, 200, 768, 1536])
def test_cuda_f16_bsr_spmm_matches_plain(cuda, feat):
    values, row, ptr, col = _card_graph(cuda, 6, 14, seed=feat, empty_rows=(2, 5))
    x = _randn(cuda, 6 * BLOCK, feat, seed=feat)
    (before,) = _counts(spmm.bsr_spmm)
    got = spmm.bsr_spmm(values, row, ptr, col, x, 6)
    assert _counts(spmm.bsr_spmm) == [(before[0], before[1], before[2] + 1)]
    assert _f32_ratio(got, spmm.spmm_plain(values, row, col, x, out_blocks=6)) <= 1.0
    assert not got[2 * BLOCK:3 * BLOCK].any() and not got[5 * BLOCK:].any()   # the empty row blocks


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [12, 128])
def test_cuda_f16_bsr_spmm_splits_long_rows_bit_identically(cuda, feat):
    """A row block of more tiles than a segment holds is split over blocks
    whose partials are summed in segment order: two calls bit-identical, the
    plain version's sums within the f32 hold, and the segment fault (its
    last segment dropped) fails it."""
    n_blocks = spmm.SEGMENT_TILES * 2 + 9
    values, row, ptr, col = _card_graph(cuda, n_blocks, 40, seed=feat, full_row=3)
    schedule = spmm.bsr_schedule(ptr, values.shape[0], exact=True)
    assert schedule.ws_slots >= 3
    x = _randn(cuda, n_blocks * BLOCK, feat, seed=1)
    got = spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule)
    want = spmm.spmm_plain(values, row, col, x, out_blocks=n_blocks)
    assert _f32_ratio(got, want) <= 1.0
    assert torch.equal(got, spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule))
    with spmm.planted_fault("segment", "bsr_spmm"):
        assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule), want) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 12, 16, 24, 64, 100, 128, 1536])
def test_cuda_f16_sampled_matmul_matches_plain(cuda, d):
    """f32 tiles of f16 operands, as JAX's kernel emits them."""
    _, row, _, col = _card_graph(cuda, 5, 9, seed=d)
    a, bt = _randn(cuda, 5 * BLOCK, d, seed=1), _randn(cuda, 5 * BLOCK, d, seed=2)
    (before,) = _counts(spmm.sampled_matmul)
    got = spmm.sampled_matmul(a, bt, row, col)
    assert _counts(spmm.sampled_matmul) == [(before[0], before[1], before[2] + 1)]
    assert got.dtype == torch.float32
    assert _f32_ratio(got, spmm.sampled_matmul_plain(a, bt, row, col)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 24, 128])
def test_cuda_f16_sampled_matmul_is_bit_identical_across_calls(cuda, d):
    """The f32 tiles, staged in shared memory and stored by TMA, come out the
    same bits in two calls (each tile's sums in one fixed order), skipped
    tiles and all, on a pattern of more tiles than the card has SMs."""
    _, row, _, col = _card_graph(cuda, 16, 150, seed=d)
    a, bt = _randn(cuda, 16 * BLOCK, d, seed=3), _randn(cuda, 16 * BLOCK, d, seed=4)
    got = spmm.sampled_matmul(a, bt, row, col)
    assert _f32_ratio(got, spmm.sampled_matmul_plain(a, bt, row, col)) <= 1.0
    assert torch.equal(got, spmm.sampled_matmul(a, bt, row, col))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(spmm.FAULTS))
def test_cuda_f16_planted_faults_fail_the_check(cuda, fault):
    """Each fault planted in the f16 kernels takes them past their check, on
    both load paths; without it they pass."""
    values, row, ptr, col = _card_graph(cuda, 4, 9, seed=7)
    for feat in (12, 128):
        x = _randn(cuda, 4 * BLOCK, feat, seed=feat)
        want = spmm.spmm_plain(values, row, col, x)
        assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, 4), want) <= 1.0
        with spmm.planted_fault(fault):
            assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, 4), want) > 1.0
    for d in (12, 16, 24):
        a, bt = _randn(cuda, 4 * BLOCK, d, seed=d), _randn(cuda, 4 * BLOCK, d, seed=d + 1)
        want = spmm.sampled_matmul_plain(a, bt, row, col)
        assert _f32_ratio(spmm.sampled_matmul(a, bt, row, col), want) <= 1.0
        with spmm.planted_fault(fault):
            assert _f32_ratio(spmm.sampled_matmul(a, bt, row, col), want) > 1.0


@pytest.mark.cuda
def test_cuda_f16_kernels_raise_on_a_misaligned_operand(cuda):
    """A TMA view of an operand that is not 16-byte aligned cannot be
    encoded: the launch returns the error and the wrapper raises. At a width
    the element loads take (F = 12) the same operand runs."""
    values, row, ptr, col = _card_graph(cuda, 2, 3, seed=8)

    def misaligned(rows, feat):
        return _randn(cuda, rows * feat + 1, seed=9)[1:].reshape(rows, feat)

    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.bsr_spmm(values, row, ptr, col, misaligned(2 * BLOCK, 64), 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        spmm.sampled_matmul(misaligned(2 * BLOCK, 16), _randn(cuda, 2 * BLOCK, 16), row, col)
    x12 = misaligned(2 * BLOCK, 12)
    assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x12, 2), spmm.spmm_plain(values, row, col, x12)) <= 1.0


# --------------------------------------------------------------- B7-B9
def _planes(cuda, offsets, n_blocks, seed):
    """Random diagonal planes in f16, zero where r + o falls outside the graph."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(len(offsets), n_blocks, BLOCK, BLOCK)).astype(np.float32)
    for i, o in enumerate(offsets):
        for r in range(n_blocks):
            if not 0 <= r + o < n_blocks:
                v[i, r] = 0.0
    return torch.from_numpy(v).to(cuda).to(F16)


BAND_OFFSETS = [(0,), (-1, 0, 1), (-3, 0, 2), (-2, -1, 0, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 3, 12, 17, 20, 24, 31, 36, 128, 136, 300, 1536])
@pytest.mark.parametrize("offsets", BAND_OFFSETS, ids=lambda o: "offsets" + "_".join(map(str, o)))
def test_cuda_f16_band_kernels_match_plain(cuda, offsets, feat):
    """Planes and packed rows: B7, B8, B9 dX on both, dV on both in f16 and
    into f32 values; each launch on the f16 counter. Widths that are no
    multiple of 8 take x in the forward and dX by one bulk copy a chunk
    below 32 columns, else by element loads."""
    nb = 5
    v = _planes(cuda, offsets, nb, seed=feat)
    radius = band.band_radius(offsets)
    v_pack = band.pack_band_rows(v, offsets, radius)
    x, dy = _randn(cuda, nb * BLOCK, feat, seed=1), _randn(cuda, nb * BLOCK, feat, seed=2)
    names = ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed", "band_dv", "band_dv_packed")
    before = _counts(*(getattr(band, n) for n in names))
    assert _f16_step_ratio(band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x)) <= 1.0
    assert _f16_step_ratio(band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x)) <= 1.0
    assert _f16_step_ratio(band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy)) <= 1.0
    assert _f16_step_ratio(band.band_dx_packed(v_pack, radius, dy),
                           band.band_dx_packed_plain(v_pack, radius, dy)) <= 1.0
    assert _f16_step_ratio(band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets)) <= 1.0
    assert _f16_step_ratio(band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius)) <= 1.0
    assert _f32_ratio(band.band_dv(dy, x, offsets, out_dtype=torch.float32),
                      band.band_dv_plain(dy, x, offsets, out_dtype=torch.float32)) <= 1.0
    after = _counts(*(getattr(band, n) for n in names))
    assert [(a[0] - b[0], a[2] - b[2]) for a, b in zip(after, before)] == [(0, 1)] * 4 + [(0, 2), (0, 1)]


@pytest.mark.cuda
def test_cuda_f32_dv_writes_f16_values(cuda):
    """f32 operands into f16 values (the f32 dV's third output type)."""
    offsets = (-1, 0, 1)
    x = torch.randn(4 * BLOCK, 24, device=cuda)
    dy = torch.randn(4 * BLOCK, 24, device=cuda)
    assert _f16_step_ratio(band.band_dv(dy, x, offsets, out_dtype=F16),
                           band.band_dv_plain(dy, x, offsets, out_dtype=F16)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(band.FAULTS))
def test_cuda_f16_band_planted_faults_fail_the_check(cuda, fault):
    offsets = (-2, -1, 0, 1, 2)
    nb = 5
    v = _planes(cuda, offsets, nb, seed=3)
    for feat in (12, 128):
        x, dy = _randn(cuda, nb * BLOCK, feat, seed=4), _randn(cuda, nb * BLOCK, feat, seed=5)
        checks = ((lambda: band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x)),
                  (lambda: band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy)),
                  (lambda: band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets)))
        for run, want in checks:
            assert _f16_step_ratio(run(), want) <= 1.0
            with band.planted_fault(fault):
                assert _f16_step_ratio(run(), want) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [3, 12, 20, 128])
def test_cuda_f16_band_kernels_take_an_x_8_bytes_off(cuda, feat):
    """x 8 bytes past a 16-byte boundary: where F % 8 != 0 the forward and dX
    load it element by element and match their plain versions (a bulk copy
    needs a 16-byte aligned span); at F = 128 its TMA view cannot be
    encoded and the wrapper raises."""
    offsets, nb, radius = (-1, 0, 1), 3, 1
    v = _planes(cuda, offsets, nb, seed=feat)
    v_pack = band.pack_band_rows(v, offsets, radius)
    x = _randn(cuda, nb * BLOCK * feat + 4, seed=feat)[4:].view(nb * BLOCK, feat)
    assert x.data_ptr() % 16 == 8
    calls = ((lambda: band.band_spmm(v, offsets, x), lambda: band.band_plain(v, offsets, x)),
             (lambda: band.band_spmm_packed(v_pack, radius, x), lambda: band.band_packed_plain(v_pack, radius, x)),
             (lambda: band.band_dx(v, offsets, x), lambda: band.band_dx_plain(v, offsets, x)))
    for run, plain in calls:
        if feat % 8:
            assert _f16_step_ratio(run(), plain()) <= 1.0
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                run()


# ------------------------------------------------------------- autograd, model
@pytest.mark.cuda
def test_cuda_f16_autograd_terms_match_the_cpu(cuda):
    """spmm (with and without a precomputed transpose) on f16 operands with
    an f16-exact dy: y f32, dV and dX f16; sddmm_relu on f16 embeddings: f32
    scores, an f32 dS that is no f16 value, dE1 and dE2 in f16 from the f32
    SpMM (two f32 launches, no f16 one)."""
    values, row, _, col = _card_graph(cuda, 4, 7, seed=3)
    values, row, col = values.cpu(), row.cpu(), col.cpu()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4 * BLOCK, 24, generator=gen).half()
    dy = torch.randn(4 * BLOCK, 24, generator=gen).half().float()
    e1 = (torch.randn(4 * BLOCK, 16, generator=gen) * 0.3).half()
    e2 = (torch.randn(16, 4 * BLOCK, generator=gen) * 0.3).half()
    ds = torch.randn(7, BLOCK, BLOCK, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        terms = []
        for pre in (False, True):
            v = values.to(dev).detach().requires_grad_()
            xx = x.to(dev).detach().requires_grad_()
            r, c = row.to(dev), col.to(dev)
            if pre:
                y = spmm.spmm_pret(v, spmm.bsr_transpose_plan(v.detach(), r, c, 4), r, c, xx)
            else:
                y = spmm.spmm(v, r, c, xx)
            y.backward(dy.to(dev))
            terms += [y, v.grad, xx.grad]
        a, b = e1.to(dev).detach().requires_grad_(), e2.to(dev).detach().requires_grad_()
        s = spmm.sddmm_relu(a, b, row.to(dev), col.to(dev))
        (before,) = _counts(spmm.bsr_spmm)
        s.backward(ds.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _counts(spmm.bsr_spmm) == [(before[0] + 2, before[1], before[2])]
        out[str(dev)] = [t.detach().cpu() for t in terms + [s, a.grad, b.grad]]
    got, want = out[str(cuda)], out["cpu"]
    assert [t.dtype for t in want] == [torch.float32, F16, F16] * 2 + [torch.float32, F16, F16]
    for g, w in zip(got, want):
        ratio = _f32_ratio(g.to(cuda), w.to(cuda)) if w.dtype == torch.float32 else _f16_step_ratio(g, w)
        assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, "hub", "tail", "band"], ids=["bsr", "hub", "tail", "band"])
def test_cuda_f16_training_step_launches_the_kernels(cuda, split):
    """One f16 step of a tiny SparseATGCN with the adaptive view and remat:
    per layer 1 hoisted and 2T per-step aggregations forward and 2T again
    under remat, dX of every product whose input needs a gradient, dV (B5)
    of every adaptive SpMM, the SDDMM's forward on the f16 B5 and its two
    backward SpMMs on the f32 B4/B6 (dS is f32); the static support's
    products on f16 B4/B6 or, on the band form, on f16 B7 and B9 dX. Loss
    and gradients finite, gradients and predictions f32."""
    graph = bsr.random_spatial_graph(700, 8, seed=3, split=split)[0]
    cfg = {"output_window": 2, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "unidirection", "remat": True, "compute_dtype": "float16"}
    model = build_sparse_atgcn(graph, cfg, device=cuda)
    t, layers = 4, 2
    x = torch.randn(2, t, model.num_nodes, 1, generator=torch.Generator(device=cuda).manual_seed(10), device=cuda)
    fns = (spmm.bsr_spmm, spmm.sampled_matmul, band.band_spmm, band.band_dx)
    for fn in fns:
        fn.launches = fn.f16_launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0
    out = model(x, train=True)
    loss = out.abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all() for p in model.parameters())
    aggs = layers * (1 + 2 * t) + layers * 2 * t     # forward and the remat recompute
    dx = layers * (2 * t - 1) + 1                   # + layer 1's hoisted input
    static = split != "band"                        # a static BSR support (else the band's planes)
    counts = {fn.__name__: (fn.launches, getattr(fn, "bf16_launches", 0), fn.f16_launches) for fn in fns}
    per_agg = 2 if static else 1                    # the static BSR support and the adaptive view
    assert counts["bsr_spmm"] == (2, 0, per_agg * (aggs + dx))
    assert counts["sampled_matmul"] == (0, 0, 1 + layers * (1 + 2 * t))
    assert counts["band_spmm"] == (0, 0, 0 if static else aggs)
    assert counts["band_dx"] == (0, 0, 0 if static else dx)


@pytest.mark.cuda
def test_cuda_wrappers_take_f16_and_reject_other_dtypes(cuda):
    """f16 operands of one dtype are taken (f32 sums from bsr_spmm, f32
    tiles from sampled_matmul, f16 from the band forward); float64 and
    mixed dtypes raise."""
    values, row, ptr, col = _card_graph(cuda, 2, 2, seed=0)
    x = _randn(cuda, 2 * BLOCK, 8)
    assert spmm.bsr_spmm(values, row, ptr, col, x, 2).dtype == torch.float32
    assert spmm.sampled_matmul(x, x, row, col).dtype == torch.float32
    assert band.band_spmm(_planes(cuda, (0,), 2, seed=1), (0,), x).dtype == F16
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        spmm.bsr_spmm(values.double(), row, ptr, col, x.double(), 2)
    with pytest.raises(TypeError, match="of one dtype"):
        spmm.bsr_spmm(values, row, ptr, col, x.float(), 2)
    with pytest.raises(TypeError, match="of one dtype"):
        spmm.sampled_matmul(x, x.bfloat16(), row, col)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("feat", [1, 3, 12, 20, 31])
def test_cuda_16bit_bsr_spmm_takes_narrow_x_by_one_bulk_copy(cuda, feat, dtype):
    """B4/B6 in bf16 and f16 at F % 8 != 0 below 32: each chunk's 64 rows of
    x by one bulk copy that producer warps move into place. Against the plain
    version on a pattern with an empty row block and a row of more tiles than
    a segment holds (split over blocks): the f32 hold, two calls bit-identical,
    and the k16 and segment faults fail it."""
    assert spmm.x_load_path(feat) == "one bulk copy a chunk"
    n_blocks = spmm.SEGMENT_TILES + 9
    values, row, ptr, col = _card_graph(cuda, n_blocks, 30, seed=feat, empty_rows=(2,), full_row=3)
    values = values.to(dtype)
    schedule = spmm.bsr_schedule(ptr, values.shape[0], exact=True)
    assert schedule.ws_slots >= 2
    x = _randn(cuda, n_blocks * BLOCK, feat, seed=feat).to(dtype)
    got = spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule)
    want = spmm.spmm_plain(values, row, col, x, out_blocks=n_blocks)
    assert _f32_ratio(got, want) <= 1.0
    assert not got[2 * BLOCK:3 * BLOCK].any()
    assert torch.equal(got, spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule))
    for kind in ("k16", "segment"):
        with spmm.planted_fault(kind, "bsr_spmm"):
            assert _f32_ratio(spmm.bsr_spmm(values, row, ptr, col, x, n_blocks, schedule), want) > 1.0
