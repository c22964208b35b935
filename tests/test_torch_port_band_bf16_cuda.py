"""The bf16 forms of the band kernels and the band-stream probe kernels on the card.

csrc/band_spmm.cu with bfloat16 operands (B7 ``band_spmm``, B8
``band_spmm_packed``, B9 ``band_dx`` and ``band_dv`` and the packed
layout's dX and dV), and csrc/band_probe.cu (``window_dot``, P1 and P3: every launch shape, pinned
plans, two calls bit-identical and a planted slice drop;
``band_slab`` per-row and batched, P2, on the tensor cores: every feature
tile, radius 0-3, chunk_rows 1-16, a planted fault and a misaligned
operand), each against its plain version at odd shapes; the bf16 autograd terms on the card against the CPU; and one
bf16 band-form SparseATGCN training step with its exact launch counts.

The tensor-core forms of B7, B8, B9 dX and dV are held at the 1M path's
widths and beyond, on both of their load paths (x by TMA where F % 8 == 0,
else by element loads), at radius 0-3, with gaps in the offsets, on one row
block and on the first and last ones, where slots fall outside the graph;
an operand that is not 16-byte aligned at a TMA width must raise, and each
fault planted in them must fail the one-bf16-step check.

Every test is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so it runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_band_bf16_cuda.py
Tolerances, each with its reason:
  * bf16 outputs: within one bf16 step of the plain version, 2^-7 |plain|
    + 2^-7 * 1e-3 max|plain| (both sum the same exact f32 products in
    another order and round once; the two f32 sums can fall on either side
    of a rounding boundary);
  * f32 outputs (window_dot, band_slab, dV in f32): rtol 1e-5 with atol
    1e-5 times max |plain| (the same products, summed in another order).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.models.sparse_atgcn import build_sparse_atgcn
from multistgraph_tpu_torch.ops import band, band_probe, bsr, spmm

BLOCK = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only on the card)")
    return torch.device("cuda")


def _planes(cuda, offsets, n_blocks, seed, dtype=torch.bfloat16):
    """Random diagonal planes, zero where r + o falls outside the graph."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(len(offsets), n_blocks, BLOCK, BLOCK)).astype(np.float32)
    for i, o in enumerate(offsets):
        for r in range(n_blocks):
            if not 0 <= r + o < n_blocks:
                v[i, r] = 0.0
    return torch.from_numpy(v).to(cuda).to(dtype)


def _randn(cuda, *shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=cuda).to(dtype)


def _within_a_bf16_step(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


def _close_f32(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(want.abs().max().item(), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 12, 17, 24, 128])
@pytest.mark.parametrize("offsets", [(-2, -1, 0, 1, 2), (-3, 0, 2), (1, -1)],
                         ids=lambda o: "offsets" + "_".join(map(str, o)))
def test_cuda_bf16_band_kernels_match_plain(cuda, offsets, feat):
    nb = 5
    v = _planes(cuda, offsets, nb, seed=feat)
    x = _randn(cuda, nb * BLOCK, feat, seed=1)
    dy = _randn(cuda, nb * BLOCK, feat, seed=2)
    before = {n: getattr(band, n).launches for n in ("band_spmm", "band_dx", "band_dv")}
    _within_a_bf16_step(band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x))
    _within_a_bf16_step(band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy))
    _within_a_bf16_step(band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets))
    # dV of bf16 operands into f32 values (the mixed case): f32 sums, unrounded
    _close_f32(band.band_dv(dy, x, offsets, out_dtype=torch.float32),
               band.band_dv_plain(dy, x, offsets, out_dtype=torch.float32))
    assert {n: getattr(band, n).launches - before[n] for n in before} == {"band_spmm": 1, "band_dx": 1,
                                                                          "band_dv": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [3, 64, 768])
@pytest.mark.parametrize("radius", [1, 2])
def test_cuda_bf16_packed_kernels_match_plain(cuda, radius, feat):
    nb = 5
    offsets = tuple(o for o in range(-radius, radius + 1) if o != 1)  # slot +1 absent
    v_pack = band.pack_band_rows(_planes(cuda, offsets, nb, seed=radius), offsets, radius)
    assert v_pack.dtype == torch.bfloat16 and v_pack.is_cuda  # packed on the card, in its dtype
    x = _randn(cuda, nb * BLOCK, feat, seed=3)
    dy = _randn(cuda, nb * BLOCK, feat, seed=4)
    before = band.band_spmm_packed.launches
    _within_a_bf16_step(band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x))
    assert band.band_spmm_packed.launches == before + 1
    _within_a_bf16_step(band.band_dx_packed(v_pack, radius, dy), band.band_dx_packed_plain(v_pack, radius, dy))
    _within_a_bf16_step(band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius))


def _misaligned(cuda, rows, feat, seed):
    """A (rows, feat) bf16 operand 2 bytes past a 16-byte boundary."""
    buf = _randn(cuda, rows * feat + 1, seed=seed)
    return buf[1:].view(rows, feat)


def _bf16_step_ratio(got, want):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    diff = (got - want).abs()
    return (diff / bound).masked_fill(diff == 0, 0.0).max().item()


# offsets at radius 0-3, with gaps; every case's first and last row blocks
# have slots outside the graph
TC_OFFSETS = [(0,), (-1, 0, 1), (-3, 0, 2), (-3, -2, -1, 0, 1, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 3, 8, 12, 17, 20, 24, 31, 36, 128, 136, 300, 1536])
@pytest.mark.parametrize("offsets", TC_OFFSETS, ids=lambda o: "offsets" + "_".join(map(str, o)))
@pytest.mark.parametrize("nb", [1, 6], ids=["one_row_block", "six_row_blocks"])
def test_cuda_tensor_core_band_kernels_match_plain(cuda, nb, offsets, feat):
    """Planes and packed rows: B7 / B8, B9 dX on both, dV on both in bf16 and
    in f32 (bf16 operands into f32 values). Widths that are no multiple of 8
    take x in the forward and dX by one bulk copy a chunk below 32 columns,
    else (at 36, and at 300 over two feature blocks of 256 columns) and in
    dV by element loads."""
    v = _planes(cuda, offsets, nb, seed=feat + nb)
    radius = band.band_radius(offsets)
    v_pack = band.pack_band_rows(v, offsets, radius)
    x = _randn(cuda, nb * BLOCK, feat, seed=11)
    dy = _randn(cuda, nb * BLOCK, feat, seed=12)
    names = ("band_spmm", "band_spmm_packed", "band_dx", "band_dx_packed", "band_dv", "band_dv_packed")
    before = {n: getattr(band, n).launches for n in names}
    _within_a_bf16_step(band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x))
    _within_a_bf16_step(band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x))
    _within_a_bf16_step(band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy))
    _within_a_bf16_step(band.band_dx_packed(v_pack, radius, dy), band.band_dx_packed_plain(v_pack, radius, dy))
    _within_a_bf16_step(band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets))
    _within_a_bf16_step(band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius))
    _close_f32(band.band_dv(dy, x, offsets, out_dtype=torch.float32),
               band.band_dv_plain(dy, x, offsets, out_dtype=torch.float32))
    _close_f32(band.band_dv_packed(dy, x, radius, out_dtype=torch.float32),
               band.band_dv_packed_plain(dy, x, radius, out_dtype=torch.float32))
    assert {n: getattr(band, n).launches - before[n] for n in names} == {
        "band_spmm": 1, "band_spmm_packed": 1, "band_dx": 1, "band_dx_packed": 1, "band_dv": 2, "band_dv_packed": 2}


@pytest.mark.cuda
def test_cuda_tensor_core_band_kernels_raise_on_a_misaligned_operand(cuda):
    """At a TMA width (F % 8 == 0) an operand that is not 16-byte aligned
    cannot be viewed: the launch fails and the wrapper raises."""
    offsets, nb, feat = (-1, 0, 1), 3, 128
    v = _planes(cuda, offsets, nb, seed=0)
    v_pack = band.pack_band_rows(v, offsets, 1)
    x, dy = _misaligned(cuda, nb * BLOCK, feat, 1), _randn(cuda, nb * BLOCK, feat, seed=2)
    assert x.is_contiguous() and x.data_ptr() % 16
    for call in (lambda: band.band_spmm(v, offsets, x), lambda: band.band_spmm_packed(v_pack, 1, x),
                 lambda: band.band_dx(v, offsets, x), lambda: band.band_dx_packed(v_pack, 1, x),
                 lambda: band.band_dv(dy, x, offsets), lambda: band.band_dv(x, dy, offsets),
                 lambda: band.band_dv_packed(dy, x, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
    # at F = 12 the element loads take it
    x12 = _misaligned(cuda, nb * BLOCK, 12, 3)
    _within_a_bf16_step(band.band_spmm(v, offsets, x12), band.band_plain(v, offsets, x12))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 3, 12, 17, 20, 31, 36, 300])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_cuda_band_span_and_element_loads_agree_bit_for_bit(cuda, dtype, feat):
    """The forward and dX on a 16-byte aligned x (below 32 columns one bulk
    copy a chunk, rearranged by the consumers) and on the same values 8
    bytes past a 16-byte boundary (element loads): the same products summed
    in the same order, so the outputs are bit-identical, on planes and packed
    rows; two calls of each are too."""
    offsets, nb, radius = (-2, -1, 0, 1, 2), 6, 2
    v = _planes(cuda, offsets, nb, seed=feat, dtype=dtype)
    v_pack = band.pack_band_rows(v, offsets, radius)
    x = _randn(cuda, nb * BLOCK, feat, dtype=dtype, seed=15)
    buf = torch.empty(nb * BLOCK * feat + 8, dtype=dtype, device=cuda)
    x_off = buf[4:4 + x.numel()].view(nb * BLOCK, feat)
    x_off.copy_(x)
    assert x.data_ptr() % 16 == 0 and x_off.data_ptr() % 16 == 8
    assert band.x_load_path(feat, False) == "element loads"
    for call in (lambda t: band.band_spmm(v, offsets, t), lambda t: band.band_spmm_packed(v_pack, radius, t),
                 lambda t: band.band_dx(v, offsets, t), lambda t: band.band_dx_packed(v_pack, radius, t)):
        got = call(x)
        assert torch.equal(got, call(x_off)) and torch.equal(got, call(x))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [12, 128])
@pytest.mark.parametrize("fault", sorted(band.FAULTS))
def test_cuda_tensor_core_planted_faults_fail_the_check(cuda, fault, feat):
    """Each fault planted in the bf16 kernels takes every form past one bf16
    step of its plain version; f32 operands take no fault."""
    offsets, nb, radius = (-2, -1, 0, 1, 2), 6, 2
    v = _planes(cuda, offsets, nb, seed=feat)
    v_pack = band.pack_band_rows(v, offsets, radius)
    x, dy = _randn(cuda, nb * BLOCK, feat, seed=13), _randn(cuda, nb * BLOCK, feat, seed=14)
    cases = ((lambda: band.band_spmm(v, offsets, x), band.band_plain(v, offsets, x)),
             (lambda: band.band_spmm_packed(v_pack, radius, x), band.band_packed_plain(v_pack, radius, x)),
             (lambda: band.band_dx(v, offsets, dy), band.band_dx_plain(v, offsets, dy)),
             (lambda: band.band_dx_packed(v_pack, radius, dy), band.band_dx_packed_plain(v_pack, radius, dy)),
             (lambda: band.band_dv(dy, x, offsets), band.band_dv_plain(dy, x, offsets)),
             (lambda: band.band_dv_packed(dy, x, radius), band.band_dv_packed_plain(dy, x, radius)))
    for call, want in cases:
        assert _bf16_step_ratio(call(), want) <= 1.0
        with band.planted_fault(fault):
            assert _bf16_step_ratio(call(), want) > 1.0
    with band.planted_fault(fault), pytest.raises(RuntimeError, match="launch failed"):
        band.band_spmm(v.float(), offsets, x.float())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
def test_cuda_bf16_band_gradients_match_the_cpu(cuda, packed):
    """bf16 x against f32 values: y and dX in bf16, dV in f32, on the card as
    on the CPU (the same rounding points; f32 sums in other orders)."""
    offsets, nb = (-2, 0, 1), 4
    v = _planes(cuda, offsets, nb, seed=5, dtype=torch.float32).cpu()
    if packed:
        v = band.pack_band_rows(v, offsets, 2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(nb * BLOCK, 24, generator=gen).bfloat16()
    dy = torch.randn(nb * BLOCK, 24, generator=gen).bfloat16()
    out = {}
    for dev in ("cpu", cuda):
        vv = v.to(dev).detach().requires_grad_()
        xx = x.to(dev).detach().requires_grad_()
        y = band.spmm_band_packed(vv, 2, xx) if packed else band.spmm_band(vv, offsets, xx)
        y.backward(dy.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, vv.grad, xx.grad)]
    got, want = out[str(cuda)], out["cpu"]
    assert [t.dtype for t in got] == [t.dtype for t in want] == [torch.bfloat16, torch.float32, torch.bfloat16]
    for g, w in zip(got, want):
        bound = 2.0 ** -7 * (w.float().abs() + 1e-3 * w.float().abs().max())
        assert ((g.float() - w.float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 128, 384, 128, "stack"), (1, 128, 640, 128, "p3"), (3, 100, 50, 70, "odd")],
                         ids=lambda s: s[-1])
def test_cuda_window_dot_matches_plain(cuda, shape):
    c, b, w, f, kind = shape
    v = _randn(cuda, c, b, w, dtype=torch.float32, seed=6)
    rows = c * w if kind == "stack" else 8 * 128
    x = _randn(cuda, rows, f, dtype=torch.float32, seed=7)
    starts = [i * w for i in range(c)] if kind == "stack" else ([128] if kind == "p3" else [0, 17, 500])
    before = band_probe.window_dot.launches
    _close_f32(band_probe.window_dot(v, x, starts), band_probe.window_dot_plain(v, x, starts))
    assert band_probe.window_dot.launches == before + 1


def _window_inputs(cuda, c, b, w, f, starts, seed):
    v = _randn(cuda, c, b, w, dtype=torch.float32, seed=seed)
    x = _randn(cuda, max(s + w for s in starts), f, dtype=torch.float32, seed=seed + 1)
    return v, x


# (C, b, W, F, starts): P1 and P3; the odd shape; C up to 6; W no multiple
# of a slice (one row, 4-row slices, a ragged last slice and a slice over
# two stages); b and F no multiples of the tile (F % 4 != 0: 4-byte copies
# and stores); starts that put no window on a 16-byte boundary
_WINDOW_SHAPES = [(4, 128, 384, 128, (0, 384, 768, 1152)), (1, 128, 640, 128, (128,)),
                  (3, 100, 50, 70, (0, 17, 500)), (6, 33, 257, 130, (5, 0, 300, 77, 1, 999)),
                  (5, 65, 1, 3, (0, 4, 9, 2, 7)), (2, 17, 30, 64, (3, 1)), (1, 200, 1000, 33, (11,)),
                  (2, 64, 264, 192, (0, 264))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WINDOW_SHAPES, ids=lambda s: "C{}_b{}_W{}_F{}".format(*s[:4]))
def test_cuda_window_dot_split_windows_match_plain(cuda, shape):
    """window_dot's slices (one block each, a cluster per output tile) at
    every launch shape its rule takes: held to the plain version, f32 rule."""
    c, b, w, f, starts = shape
    v, x = _window_inputs(cuda, c, b, w, f, starts, seed=20)
    before = band_probe.window_dot.launches
    _close_f32(band_probe.window_dot(v, x, starts), band_probe.window_dot_plain(v, x, starts))
    assert band_probe.window_dot.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32, 64])
@pytest.mark.parametrize("slices", [1, 3, 6, 8])
def test_cuda_window_dot_every_pinned_plan_matches_plain(cuda, slices, rows):
    """Tile heights and cluster sizes pinned through window_dot_launch_plan,
    at P1's shape and at an odd one; a 9-block cluster is refused."""
    import ctypes

    lib = band_probe._lib()
    for c, b, w, f, starts in (_WINDOW_SHAPES[0], _WINDOW_SHAPES[3]):
        v, x = _window_inputs(cuda, c, b, w, f, starts, seed=21)
        out = torch.full((c, b, f), float("nan"), device=cuda)
        dev_starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
        rc = lib.window_dot_launch_plan(v.data_ptr(), x.data_ptr(), dev_starts.data_ptr(), out.data_ptr(), c, b, w,
                                        f, slices, rows, 0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert rc == 0
        _close_f32(out, band_probe.window_dot_plain(v, x, starts))
    assert lib.window_dot_launch_plan(v.data_ptr(), x.data_ptr(), dev_starts.data_ptr(), out.data_ptr(), c, b, w, f, 9,
                                      rows, 0, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WINDOW_SHAPES[:4], ids=lambda s: "C{}_b{}_W{}_F{}".format(*s[:4]))
def test_cuda_window_dot_is_bit_identical_across_calls(cuda, shape):
    """The slices' partials are summed in slice order by one block: two
    calls give the same bits."""
    c, b, w, f, starts = shape
    v, x = _window_inputs(cuda, c, b, w, f, starts, seed=22)
    first = band_probe.window_dot(v, x, starts)
    assert torch.equal(band_probe.window_dot(v, x, starts), first)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _WINDOW_SHAPES[:5], ids=lambda s: "C{}_b{}_W{}_F{}".format(*s[:4]))
def test_cuda_window_dot_planted_slice_drop_fails_the_check(cuda, shape):
    """The fault planted in window_dot's kernel (the last slice's partial
    left out of the sums) takes it past the f32 check; outside the block
    the kernel passes."""
    c, b, w, f, starts = shape
    v, x = _window_inputs(cuda, c, b, w, f, starts, seed=23)
    want = band_probe.window_dot_plain(v, x, starts)
    with band_probe.planted_fault("slice"):
        assert _f32_ratio(band_probe.window_dot(v, x, starts), want) > 1.0
    assert _f32_ratio(band_probe.window_dot(v, x, starts), want) <= 1.0


@pytest.mark.cuda
def test_cuda_window_plan_fills_the_card_at_the_probe_shapes(cuda):
    """P1 takes 6 slices of 64 rows under 64-row tiles, P3 6 slices of 108
    under 16-row tiles: 96 blocks each on the H100's 132 SMs."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the plan at the probe shapes is pinned for a card of 132 SMs")
    assert band_probe.window_plan(4, 128, 384, 128) == (64, 6)
    assert band_probe.window_plan(1, 128, 640, 128) == (16, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [8, 16, 24, 128, 136, 264])
@pytest.mark.parametrize("chunk_rows", [1, 3, 8, 16])
@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
def test_cuda_band_slab_matches_plain(cuda, batched, radius, chunk_rows, feat):
    """band_slab on the tensor cores: every feature tile (F = 8 and 16 take
    N = 16, 24 N = 24, 136 and 264 a ragged last tile), radius 0-3, one row
    block a slab and slabs longer than R; 11 row blocks leave a short last
    slab at chunk_rows 3 and 8."""
    nb = 11
    v_pack = _randn(cuda, nb, BLOCK, (2 * radius + 1) * BLOCK, seed=8)
    xp = _randn(cuda, nb + 2 * radius, BLOCK, feat, seed=9)
    counts = (band_probe.band_slab.launches, band_probe.band_slab.batched_launches)
    _close_f32(band_probe.band_slab(v_pack, xp, radius, chunk_rows=chunk_rows, batched=batched),
               band_probe.band_slab_plain(v_pack, xp, radius))
    assert (band_probe.band_slab.launches - counts[0], band_probe.band_slab.batched_launches - counts[1]) == (
        (0, 1) if batched else (1, 0))


def _f32_ratio(got, want):
    """The largest error over rtol 1e-5, atol 1e-5 max|want| (over 1: the check fails)."""
    torch.cuda.synchronize()
    bound = 1e-5 * (want.abs() + want.abs().max())
    return ((got - want).abs() / bound).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
@pytest.mark.parametrize("fault", sorted(band_probe.FAULTS))
def test_cuda_band_slab_planted_faults_fail_the_check(cuda, fault, batched):
    """Each fault planted in band_slab's kernel (a k16 slice dropped, the
    window a row block late) takes it past the f32 check; outside the
    block the kernel passes."""
    radius, nb, feat = 2, 9, 128
    v_pack = _randn(cuda, nb, BLOCK, (2 * radius + 1) * BLOCK, seed=10)
    xp = _randn(cuda, nb + 2 * radius, BLOCK, feat, seed=11)
    want = band_probe.band_slab_plain(v_pack, xp, radius)
    with band_probe.planted_fault(fault):
        assert _f32_ratio(band_probe.band_slab(v_pack, xp, radius, 4, batched), want) > 1.0
    assert _f32_ratio(band_probe.band_slab(v_pack, xp, radius, 4, batched), want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
def test_cuda_band_slab_raises_on_a_misaligned_operand(cuda, batched):
    """F = 128 takes the window by TMA: an operand 2 bytes past a 16-byte
    boundary cannot be viewed, so the launch fails and the wrapper raises."""
    radius, nb, feat = 1, 3, 128
    v_pack = _randn(cuda, nb, BLOCK, 3 * BLOCK, seed=12)
    xp = _randn(cuda, (nb + 2) * BLOCK * feat + 1, seed=13)[1:].view(nb + 2, BLOCK, feat)
    assert xp.is_contiguous() and xp.data_ptr() % 16
    with pytest.raises(RuntimeError, match="launch failed"):
        band_probe.band_slab(v_pack, xp, radius, 2, batched)
    v_bad = _randn(cuda, nb * BLOCK * 3 * BLOCK + 1, seed=14)[1:].view(nb, BLOCK, 3 * BLOCK)
    with pytest.raises(RuntimeError, match="launch failed"):
        band_probe.band_slab(v_bad, _randn(cuda, nb + 2, BLOCK, feat, seed=15), radius, 2, batched)


@pytest.mark.cuda
def test_cuda_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v_pack = _randn(cuda, 2, BLOCK, 3 * BLOCK)
    with pytest.raises(ValueError, match="multiple of 8"):
        band_probe.band_slab(v_pack, _randn(cuda, 4, BLOCK, 12), 1)
    with pytest.raises(TypeError, match="bfloat16"):
        band_probe.band_slab(v_pack.float(), _randn(cuda, 4, BLOCK, 16).float(), 1)
    with pytest.raises(ValueError, match="leaves x"):
        band_probe.window_dot(_randn(cuda, 1, 4, 8, dtype=torch.float32), _randn(cuda, 10, 3, dtype=torch.float32),
                              [3])


@pytest.mark.cuda
def test_cuda_bf16_band_training_step_launches_the_kernels(cuda):
    """One bf16 step of a tiny band SparseATGCN without the adaptive view:
    per layer 1 hoisted and 2T per-step band products forward and 2T again
    under remat, and B9 dX of every product whose input needs a gradient;
    no BSR kernel. Loss finite, gradients f32, predictions f32."""
    graph = bsr.random_spatial_graph(700, 8, seed=3, split="band")[0]
    cfg = {"output_window": 2, "output_dim": 1, "rnn_units": 8, "num_layers": 2, "embed_dim_adj": 4,
           "adpadj": "none", "remat": True, "compute_dtype": "bfloat16"}
    model = build_sparse_atgcn(graph, cfg, device=cuda)
    assert model.support0_band_values.dtype == torch.bfloat16
    t, layers = 4, 2
    x = _randn(cuda, 2, t, model.num_nodes, 1, dtype=torch.float32, seed=10)
    counters = (band.band_spmm, band.band_dx, band.band_dv, spmm.bsr_spmm, spmm.sampled_matmul)
    for fn in counters:
        fn.launches = 0
    out = model(x, train=True)
    loss = out.abs().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all() for p in model.parameters())
    assert [fn.launches for fn in counters] == [layers * (1 + 2 * t) + layers * 2 * t, layers * (2 * t - 1) + 1,
                                                0, 0, 0]
