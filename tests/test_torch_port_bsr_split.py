"""The segment schedule of the port's B4/B6 kernel (ops/spmm.py:bsr_schedule)
on the CPU: each row block's tiles cut into segments of at most S tiles,
one thread block each on the card, a split row's partial sums added in
segment order.

Checked here, exactly (integer arrays): every tile is covered once, in row
order; no segment holds more than S tiles; a row of at most S tiles (or
none) gets one segment; the schedule's size and its workspace slots stay
within the bounds the wrapper allocates from the shapes alone. The
schedule's arithmetic, each segment's product summed and the split rows'
partials added in segment order as csrc/bsr_spmm.cu adds them, is held
against spmm_plain at rtol 1e-5 with atol 1e-6 times its max |value| (the
same f32 products summed in another order). The kernel itself runs only on
the card (tests/test_torch_port_sparse_cuda.py and _sparse_bf16_cuda.py).
"""

import numpy as np
import pytest
import torch

from multistgraph_tpu_torch.ops import spmm

BLOCK = 8   # the plain versions take any tile edge; the schedule never reads one


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other CPU tests use beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _row_ptr(counts):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))


# tiles per row block: empty rows, a row of exactly S, one of S + 1, a hub
# row of many segments, a single tile
PATTERNS = {
    "mixed": [0, 3, 0, 7, 1, 0, 12, 2],
    "hub": [1, 40, 2, 0, 1, 33, 1],
    "exact": [4, 4, 8, 5],
    "one tile": [1],
    "empty": [0, 0, 0],
}


def _segments(counts, seg_tiles):
    sched = spmm.bsr_schedule(_row_ptr(counts), int(sum(counts)), seg_tiles)
    return sched, sched.segments.numpy()


@pytest.mark.parametrize("seg_tiles", [1, 4, 16])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_schedule_covers_every_tile_once_in_row_order(name, seg_tiles):
    counts = PATTERNS[name]
    sched, seg = _segments(counts, seg_tiles)
    assert sched.segments.dtype == torch.int32 and seg.shape[1] == 8
    live = seg[seg[:, 0] >= 0]
    assert (seg[seg[:, 0] < 0] == -1).all()          # padding rows only after the segments
    assert (seg[: len(live), 0] >= 0).all()
    sizes = live[:, 2] - live[:, 1]
    assert (np.diff(sizes) <= 0).all()               # the longest segments first,
    for size in np.unique(sizes):                    # then by index in the row, then by row
        same = live[sizes == size]
        assert (np.diff(same[:, 3] * len(counts) + same[:, 0]) > 0).all()
    # in row order, each row's segments k = 0 .. nseg - 1 cover its tiles in order: [0, nnz) once
    in_order = live[np.lexsort((live[:, 3], live[:, 0]))]
    tiles = np.concatenate([np.arange(f, e) for _, f, e, *_ in in_order] + [np.zeros(0, int)])
    np.testing.assert_array_equal(tiles, np.arange(sum(counts)))
    ptr = _row_ptr(counts).numpy()
    for row, first, end, k, nseg, _, _, _ in live:
        assert ptr[row] <= first <= end <= ptr[row + 1]
        assert end - first <= seg_tiles
        assert nseg == max(1, -(-counts[row] // seg_tiles)) and 0 <= k < nseg
    # one segment per row of at most S tiles
    rows = in_order[:, 0]
    np.testing.assert_array_equal(np.unique(rows), np.arange(len(counts)))
    for r, n in enumerate(counts):
        np.testing.assert_array_equal(in_order[rows == r, 3], np.arange(max(1, -(-n // seg_tiles))))
        if n <= seg_tiles:
            assert (rows == r).sum() == 1


@pytest.mark.parametrize("seg_tiles", [1, 2, 4, 16])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_schedule_stays_within_its_shape_bounds(name, seg_tiles):
    """M = out_blocks + nnz // S rows hold every segment, and a split row's
    workspace slots are distinct and below ws_slots = 2 nnz // (S + 1), or
    exactly as many as the split rows take where counted (exact)."""
    counts = PATTERNS[name]
    nnz = int(sum(counts))
    sched, seg = _segments(counts, seg_tiles)
    assert seg.shape[0] == len(counts) + nnz // seg_tiles
    assert sched.ws_slots == 2 * nnz // (seg_tiles + 1)
    split = seg[(seg[:, 0] >= 0) & (seg[:, 4] > 1)]
    slots = split[:, 5] + split[:, 3]
    assert len(np.unique(slots)) == len(slots) and (slots < sched.ws_slots).all() and (slots >= 0).all()
    assert (seg[(seg[:, 0] >= 0) & (seg[:, 4] == 1), 5] == -1).all()
    exact = spmm.bsr_schedule(_row_ptr(counts), nnz, seg_tiles, exact=True)
    assert torch.equal(exact.segments, sched.segments) and exact.ws_slots == len(slots)


def test_schedule_edges():
    """An empty row gets one empty segment; a row of exactly S tiles one full
    one; a single tile one; S + 1 tiles two. Longest first, then by index
    in the row, then by row."""
    _, seg = _segments([0, 4, 5, 1], 4)
    live = seg[seg[:, 0] >= 0][:, :5].tolist()
    assert live == [[1, 0, 4, 0, 1], [2, 4, 8, 0, 2], [3, 9, 10, 0, 1], [2, 8, 9, 1, 2], [0, 0, 0, 0, 1]]
    with pytest.raises(ValueError, match="at least one tile"):
        spmm.bsr_schedule(_row_ptr([1]), 1, 0)


def _pattern(counts, n_in_blocks, seed):
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    col = np.concatenate([np.sort(rng.choice(n_in_blocks, size=n, replace=False)) for n in counts]
                         + [np.zeros(0, int)]).astype(np.int32)
    values = rng.normal(size=(len(row), BLOCK, BLOCK)).astype(np.float32)
    return torch.from_numpy(values), torch.from_numpy(row), torch.from_numpy(col)


@pytest.mark.parametrize("seg_tiles", [1, 3, 16])
@pytest.mark.parametrize("name", ["mixed", "hub"])
def test_segmented_sums_match_the_plain_product(name, seg_tiles):
    """Each segment's tiles summed, split rows' partials then added in
    segment order through their workspace slots: the plain product."""
    counts = PATTERNS[name]
    n_in = max(counts) + 1
    values, row, col = _pattern(counts, n_in, seed=seg_tiles)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(n_in * BLOCK, 5)).astype(np.float32))
    sched = spmm.bsr_schedule(_row_ptr(counts), len(row), seg_tiles)
    ws = torch.full((max(sched.ws_slots, 1), BLOCK, 5), float("nan"))
    out = torch.full((len(counts), BLOCK, 5), float("nan"))
    xb = x.reshape(-1, BLOCK, 5)
    for r, first, end, k, nseg, ws_base, _, _ in sched.segments.tolist():
        if r < 0:
            continue
        part = torch.zeros(BLOCK, 5)
        for p in range(first, end):
            part += values[p] @ xb[col[p]]
        if nseg == 1:
            out[r] = part
        else:
            ws[ws_base + k] = part
    for r, first, end, k, nseg, ws_base, _, _ in sched.segments.tolist():
        if r >= 0 and nseg > 1 and k == 0:
            total = torch.zeros(BLOCK, 5)
            for s in range(nseg):
                total += ws[ws_base + s]
            out[r] = total
    want = spmm.spmm_plain(values, row, col, x, block=BLOCK, out_blocks=len(counts))
    torch.testing.assert_close(out.reshape(want.shape), want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def test_transpose_plan_carries_the_row_offsets_and_schedule():
    """bsr_transpose_plan: bsr_transpose, then the transposed graph's
    row_ptr and schedule, as the backward would build them."""
    counts = PATTERNS["mixed"]
    nb = max(counts) + 1   # x's row blocks: the transposed graph's rows
    values, row, col = _pattern(counts, nb, seed=3)
    v_t, r_t, c_t, ptr_t, sched_t = spmm.bsr_transpose_plan(values, row, col, nb)
    for a, b in zip((v_t, r_t, c_t), spmm.bsr_transpose(values, row, col, nb)):
        assert torch.equal(a, b)
    assert torch.equal(ptr_t, spmm.row_ptr_of(r_t, nb))
    want = spmm.bsr_schedule(ptr_t, len(r_t))
    assert torch.equal(sched_t.segments, want.segments) and sched_t.ws_slots == want.ws_slots
    # the same from the pattern alone, as the model builds it once
    ptr_p, sched_p = spmm.bsr_transpose_schedule(row, col, nb)
    assert torch.equal(ptr_p, ptr_t) and torch.equal(sched_p.segments, want.segments)


def test_spmm_backward_takes_the_plan_it_is_given():
    """With a plan, the backward's dX builds no row offsets and no schedule
    (they come with the plan); with none it transposes A and builds them
    itself. The gradients agree either way."""
    counts = PATTERNS["hub"]
    nb = max(counts) + 1   # x's row blocks: the transposed graph's rows
    values, row, col = _pattern(counts, nb, seed=5)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(nb * BLOCK, 3)).astype(np.float32))
    grads = []
    with pytest.MonkeyPatch.context() as mp:
        built = []
        real_ptr, real_sched = spmm.row_ptr_of, spmm.bsr_schedule
        mp.setattr(spmm, "row_ptr_of", lambda *a, **k: built.append("row_ptr") or real_ptr(*a, **k))
        mp.setattr(spmm, "bsr_schedule", lambda *a, **k: built.append("schedule") or real_sched(*a, **k))
        for pre_t in (spmm.bsr_transpose_plan(values, row, col, nb), None):
            built.clear()
            xt = x.clone().requires_grad_()
            y = spmm.spmm_pret(values, pre_t, row, col, xt, block=BLOCK, out_blocks=len(counts),
                               row_ptr=real_ptr(row, len(counts)))
            y.sum().backward()
            grads.append(xt.grad)
            assert built == ([] if pre_t is not None else ["row_ptr", "schedule"])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_sddmm_backward_takes_the_transpose_it_is_given():
    """sddmm_relu's dE2 runs over the pattern's block transpose: given that
    transpose's row offsets and schedule (as the model passes them, built
    once), the backward builds neither; without them it builds both. The
    gradients agree either way."""
    counts = [3, 6, 0, 5, 1, 2]   # square: as many row blocks as column blocks
    nb, block = len(counts), spmm.BLOCK   # sampled_matmul takes 128-row blocks only
    _, row, col = _pattern(counts, nb, seed=7)
    rng = np.random.default_rng(4)
    e1 = torch.from_numpy(rng.normal(size=(nb * block, 5)).astype(np.float32))
    e2 = torch.from_numpy(rng.normal(size=(5, nb * block)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(size=(len(row), block, block)).astype(np.float32))
    transpose = spmm.bsr_transpose_schedule(row, col, nb)
    grads = []
    with pytest.MonkeyPatch.context() as mp:
        built = []
        real_ptr, real_sched = spmm.row_ptr_of, spmm.bsr_schedule
        mp.setattr(spmm, "row_ptr_of", lambda *a, **k: built.append("row_ptr") or real_ptr(*a, **k))
        mp.setattr(spmm, "bsr_schedule", lambda *a, **k: built.append("schedule") or real_sched(*a, **k))
        row_ptr, sched = real_ptr(row, nb), real_sched(real_ptr(row, nb), len(row))
        for given in (transpose, None):
            built.clear()
            a, b = e1.clone().requires_grad_(), e2.clone().requires_grad_()
            spmm.sddmm_relu(a, b, row, col, block=block, row_ptr=row_ptr, schedule=sched,
                            transpose=given).backward(ds)
            grads.append((a.grad, b.grad))
            assert built == ([] if given is not None else ["row_ptr", "schedule"])
    for got, want in zip(grads[0], grads[1]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("feat, aligned, path", [
    (16, True, "TMA"), (24, False, "TMA"), (1536, True, "TMA"), (1, True, "one bulk copy a chunk"),
    (3, True, "one bulk copy a chunk"), (12, True, "one bulk copy a chunk"), (20, True, "one bulk copy a chunk"),
    (31, True, "one bulk copy a chunk"), (12, False, "element loads"), (33, True, "element loads"),
    (36, True, "element loads")])
def test_bsr_spmm_takes_narrow_x_by_one_bulk_copy_below_the_cap_where_aligned(feat, aligned, path):
    """bsr_spmm's 16-bit kernel: x by TMA in whole 16-byte rows (an unaligned
    x then fails to encode and raises); below SPAN_MAX_F columns each
    chunk's 64 contiguous rows of one x block by one bulk copy where x is
    16-byte aligned (the spans' staging keeps two blocks an SM: the k16
    fault's zero operand is in shared memory only under that fault); else
    element by element. The band kernels' forward and dX take the same rule."""
    from multistgraph_tpu_torch.ops import band

    assert spmm.x_load_path(feat, aligned) == path
    assert spmm.SPAN_MAX_F == 32
    assert band.x_load_path is spmm.x_load_path and band.SPAN_MAX_F == spmm.SPAN_MAX_F
