"""Banded-dense SpMM with autograd: kernels B7, B8 and B9 (dX, dV).

Counterpart of multistgraph_tpu/ops/band.py. After hub extraction the
spatial graph's remainder is a block band: every nonzero 128x128 tile sits
at a small block offset o = col_block - row_block. For each offset the
tiles form one diagonal, stored as a dense plane, and

    y[r] = sum_o V[o, r] @ x[r + o]          (rows r + o outside [0, R) add nothing)

Two storage forms, as in JAX:
  * planes ``band_values`` (O, R, b, b) with host-side ``offsets`` (O,),
    trained through ``spmm_band``;
  * the packed form ``pack_band_rows`` (R, b, (2 radius + 1) b), slot j of
    row block r holding the tile at offset j - radius (zero for an absent
    offset), served through ``spmm_band_packed``.

Kernels (csrc/band_spmm.cu, one source): ``band_spmm`` (B7, the planes'
forward), ``band_spmm_packed`` (B8, the packed forward), ``band_dx`` (B9's
dX, the transposed band, on planes) and ``band_dv`` (B9's dV, the sampled
outer product at the band's tiles). The packed form's backward runs on the
same two B9 kernels reading the packed layout (``band_dx_packed``,
``band_dv_packed``): no transposed copy of the values is packed, which
keeps a second 126 MB array per graph out of memory at 49,152 nodes. Each
wrapper launches its kernel for CUDA tensors, counts the launch in
``.launches`` (float32 and bfloat16 operands) or ``.f16_launches``
(float16 operands) and raises on what the kernel does not take; for CPU tensors
it takes its plain PyTorch version, which keeps JAX's band algebra
(band.py:672-759, 609-642): the forward "orij,orjf->rif" over slices of a
zero-padded x, dV "rif,orjf->orij", dX by shifted adds into a padded
buffer whose core is returned. The kernels form no padded copy: they skip
a slot whose operand row block lies outside the graph and write dX
straight into (N_pad, F). bf16 and f16 operands run on the tensor cores
(wgmma, the tiles by TMA, x by TMA where F % 8 == 0, else the forward and
dX below 32 columns by one bulk copy of each chunk's rows where x is
16-byte aligned, else and in dV by element loads: ``x_load_path``,
``bf16_load_path``); a TMA view that the shape allows and
cuTensorMapEncodeTiled refuses (an operand that is not 16-byte aligned)
raises. f32 operands run full f32 FMAs on csrc/simt_f32.cuh's mainloop,
dV on its sampled kernel (B5's). ``planted_fault`` plants a fault in the
16-bit kernels and the f32 dV for the checks that must catch one.

Types, as the JAX package's (band.py:587-588,623,678,691-692,727-736):
float32, bfloat16 or float16 operands. The kernel wrappers take the tiles
and x of one dtype; ``spmm_band`` casts the planes to x's dtype inside its
autograd Function and ``spmm_band_packed`` casts the packed rows before it,
where JAX casts them. Products of two bf16 or two f16 values are exact in
f32 and every sum is f32, in the kernels and in the plain versions alike
(which widen to f32, sum in f32 and round once), so the two differ only in
summation order. The forward and dX round once to x's dtype; dV to the
values' dtype, so bf16 x with f32 planes gives an f32 dV and a bf16 dX.
The backward rounds dy to x's dtype before its kernels. f16 has a range
of 65504: a sum past it rounds to inf where the output is f16, as in JAX,
which scales no loss.

Not ported, being TPU dispatch or memory mechanisms: the Pallas/einsum
switch (``_pallas_mode``, MSG_BAND_PALLAS, ``_tile_kernels_for_training``),
the VMEM budgets of the slab kernel, the feature chunking of the stacked
einsum and the 128-column padding of ``_band_packed_apply``.
"""

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from multistgraph_tpu_torch.ops import _cuda
from multistgraph_tpu_torch.ops.spmm import BLOCK, DTYPES, _check_common
# the 16-bit forward's and dX's x come by x_load_path's rule, dV's operands by bf16_load_path's
from multistgraph_tpu_torch.ops.spmm import SPAN_MAX_F, bf16_load_path, x_load_path  # noqa: F401

MAX_OFFSETS = 8  # offsets the kernels take by value (split_band keeps at most 8 by default)


@dataclass(frozen=True)
class BandGraph:
    """Dense offset diagonals plus the COO remainder that did not fit a band."""

    band_values: np.ndarray   # (O, R_blocks, b, b) float32
    offsets: np.ndarray       # (O,) int64 block offsets (col_block - row_block)
    num_nodes: int
    block: int
    rest_src: np.ndarray      # (E_rest,) int64: leftover edges (original ids)
    rest_dst: np.ndarray
    rest_w: np.ndarray

    @property
    def padded_nodes(self) -> int:
        return -(-self.num_nodes // self.block) * self.block

    @property
    def num_row_blocks(self) -> int:
        return self.padded_nodes // self.block

    @property
    def nnz_edges(self) -> int:
        return int((self.band_values != 0).sum()) + int(self.rest_w.shape[0])


def split_band(src: np.ndarray, dst: np.ndarray, weights: np.ndarray, num_nodes: int, block: int = 128,
               max_offsets: int = 8, min_fill_frac: float = 0.25) -> BandGraph:
    """Partition COO edges into (dense offset diagonals, COO remainder).

    An offset diagonal is densified when it holds tiles in at least
    `min_fill_frac` of the row blocks, keeping at most the `max_offsets`
    most populous offsets. Duplicate edges accumulate (np.add.at order)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(weights, np.float32)
    n_blocks = -(-num_nodes // block)

    rb, cb = src // block, dst // block
    off = cb - rb
    # tiles per offset: distinct row blocks present on each diagonal
    uniq_pairs = np.unique(off * np.int64(n_blocks) + rb)
    off_of_pair = uniq_pairs // n_blocks
    cand, counts = np.unique(off_of_pair, return_counts=True)
    keep = cand[counts >= max(1, int(min_fill_frac * n_blocks))]
    if len(keep) > max_offsets:
        order = np.argsort(-counts[np.isin(cand, keep)], kind="stable")
        keep = keep[order[:max_offsets]]
        keep = np.sort(keep)

    in_band = np.isin(off, keep)
    offsets = np.sort(keep)
    pos = {int(o): i for i, o in enumerate(offsets)}
    band_values = np.zeros((len(offsets), n_blocks, block, block), np.float32)
    if in_band.any():
        oi = np.array([pos[int(o)] for o in off[in_band]], np.int64)
        np.add.at(band_values, (oi, rb[in_band], src[in_band] % block, dst[in_band] % block), w[in_band])
    rest = ~in_band
    return BandGraph(band_values=band_values, offsets=offsets.astype(np.int64), num_nodes=num_nodes,
                     block=block, rest_src=src[rest], rest_dst=dst[rest], rest_w=w[rest])


def band_radius(offsets) -> int:
    return max((abs(int(o)) for o in offsets), default=0)


def pack_band_rows(band_values, offs, radius: int):
    """(O, R, b, b) diagonals -> (R, b, W) packed rows, W = (2 radius + 1) b:
    slot o + radius of row block r holds V_o[r]; absent offsets are zero.
    Takes a numpy array or a tensor (packed on its device) and keeps its
    dtype, as JAX's works on numpy or jnp arrays."""
    _, r_blocks, b, _ = band_values.shape
    w = (2 * radius + 1) * b
    if isinstance(band_values, torch.Tensor):
        packed = band_values.new_zeros((r_blocks, b, w))
    else:
        packed = np.zeros((r_blocks, b, w), band_values.dtype)
    for i, o in enumerate(offs):
        sl = (int(o) + radius) * b
        packed[:, :, sl:sl + b] = band_values[i]
    return packed


def pack_band_rows_transposed(band_values, offs, radius: int):
    """Packed form of A^T: A^T's diagonal at offset -o holds V_o[r]^T at
    row block r + o. Same slot layout, inputs and dtype as pack_band_rows."""
    _, r_blocks, b, _ = band_values.shape
    w = (2 * radius + 1) * b
    if isinstance(band_values, torch.Tensor):
        packed = band_values.new_zeros((r_blocks, b, w))
    else:
        packed = np.zeros((r_blocks, b, w), band_values.dtype)
    for i, o in enumerate(offs):
        o = int(o)
        lo, hi = max(0, o), min(r_blocks, r_blocks + o)
        src = band_values[i, lo - o if o < 0 else 0: r_blocks - o if o > 0 else r_blocks]
        sl = (-o + radius) * b
        packed[lo:hi, :, sl:sl + b] = src.swapaxes(1, 2)
    return packed


# ----------------------------------------------------------- plain versions
def _padded_blocks(x, block, radius):
    """x (N_pad, F) -> (R + 2 radius, block, F) with zero blocks on both ends."""
    xb = x.reshape(-1, block, x.shape[1])
    return torch.nn.functional.pad(xb, (0, 0, 0, 0, radius, radius))


def _shifted_adds(contrib, shifts, n_blocks, radius):
    """sum_i contrib[i] placed at blocks shifts[i] .. shifts[i] + R of a
    zero (R + 2 radius)-block buffer; returns its core (R, block, F)."""
    _, _, block, feat = contrib.shape
    dxp = contrib.new_zeros(n_blocks + 2 * radius, block, feat)
    for i, s in enumerate(shifts):
        dxp[s:s + n_blocks] += contrib[i]
    return dxp[radius:radius + n_blocks]


def band_plain(band_values, offsets: Sequence[int], x, block: int = BLOCK):
    """y = A_band x: the stacked einsum "orij,orjf->rif" over slices of the
    zero-padded x (JAX _band_apply), in f32, rounded once to x's dtype."""
    n_pad, feat = x.shape
    nb = n_pad // block
    radius = band_radius(offsets)
    xp = _padded_blocks(x.float(), block, radius)
    xs = torch.stack([xp[radius + o: radius + o + nb] for o in offsets])
    return torch.einsum("orij,orjf->rif", band_values.float(), xs).reshape(n_pad, feat).to(x.dtype)


def band_dx_plain(band_values, offsets: Sequence[int], dy, block: int = BLOCK):
    """dx = A_band^T dy: contributions "orij,rif->orjf" added at block r + o
    of a padded buffer (JAX _band_bwd); the buffer's core, rounded once to
    dy's dtype."""
    n_pad, feat = dy.shape
    nb = n_pad // block
    radius = band_radius(offsets)
    contrib = torch.einsum("orij,rif->orjf", band_values.float(), dy.float().reshape(nb, block, feat))
    return _shifted_adds(contrib, [radius + o for o in offsets], nb, radius).reshape(n_pad, feat).to(dy.dtype)


def band_dv_plain(dy, x, offsets: Sequence[int], block: int = BLOCK, out_dtype=None):
    """dV[o, r] = dy[r] x[r + o]^T: "rif,orjf->orij" (zero where r + o is
    outside the graph), rounded once to out_dtype (default x's)."""
    n_pad, feat = x.shape
    nb = n_pad // block
    radius = band_radius(offsets)
    xp = _padded_blocks(x.float(), block, radius)
    xs = torch.stack([xp[radius + o: radius + o + nb] for o in offsets])
    return torch.einsum("rif,orjf->orij", dy.float().reshape(nb, block, feat), xs).to(out_dtype or x.dtype)


def band_packed_plain(v_pack, radius: int, x, block: int = BLOCK):
    """y = A_band x from the packed rows: "rijw,jrwf->rif" on the
    (R, b, 2r+1, b) view against the 2r+1 windows of the padded x (JAX
    _band_packed_apply), in f32, rounded once to x's dtype."""
    n_pad, feat = x.shape
    nb, n_off = n_pad // block, 2 * radius + 1
    xp = _padded_blocks(x.float(), block, radius)
    xs = torch.stack([xp[j:j + nb] for j in range(n_off)])
    vr = v_pack.float().reshape(nb, block, n_off, block)
    return torch.einsum("rijw,jrwf->rif", vr, xs).reshape(n_pad, feat).to(x.dtype)


def band_dx_packed_plain(v_pack, radius: int, dy, block: int = BLOCK):
    """dx = A_band^T dy from the packed rows: "rijw,rif->jrwf" added at block
    j of the padded buffer (JAX _band_packed_bwd); the buffer's core,
    rounded once to dy's dtype."""
    n_pad, feat = dy.shape
    nb, n_off = n_pad // block, 2 * radius + 1
    vr = v_pack.float().reshape(nb, block, n_off, block)
    contrib = torch.einsum("rijw,rif->jrwf", vr, dy.float().reshape(nb, block, feat))
    return _shifted_adds(contrib, range(n_off), nb, radius).reshape(n_pad, feat).to(dy.dtype)


def band_dv_packed_plain(dy, x, radius: int, block: int = BLOCK, out_dtype=None):
    """dV_pack[r, i, (j, w)] = sum_f dy[r, i, f] xp[r + j, w, f], rounded
    once to out_dtype (default x's)."""
    n_pad, feat = x.shape
    nb, n_off = n_pad // block, 2 * radius + 1
    xp = _padded_blocks(x.float(), block, radius)
    xs = torch.stack([xp[j:j + nb] for j in range(n_off)])
    dv = torch.einsum("rif,jrwf->rijw", dy.float().reshape(nb, block, feat), xs)
    return dv.reshape(nb, block, n_off * block).to(out_dtype or x.dtype)


# ------------------------------------------------------------ CUDA wrappers
# Faults the 16-bit (tensor-core) kernels and the f32 dV plant on request, for
# checks that must fail them (chip_smoke.py): the k16 slice holding each
# product's last contraction element dropped, the middle slot skipped (the
# main diagonal of offsets -r..r), the last row block read as outside the
# graph.
FAULTS = {"k16": 1, "slot": 2, "edge": 3}
_planted = 0


@contextlib.contextmanager
def planted_fault(kind: str):
    """Launch the 16-bit kernels and the f32 dV with the fault FAULTS[kind]
    planted in them while the block runs (the f32 forward and dX then
    raise)."""
    global _planted
    code = FAULTS[kind]
    _planted = code
    try:
        yield
    finally:
        _planted = 0


@functools.cache
def _kernel(entry: str):
    fn = getattr(_cuda.library("band_spmm"), entry)
    # values/dy, x, out; R, F, slots, radius, packed, then transposed and
    # dtype (band_spmm_launch) or in and out dtypes (band_dv_launch); 8
    # offsets; the fault (the *_fault entries); stream
    extra = int(entry.endswith("_fault"))
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (7 + MAX_OFFSETS + extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry, tensors, ints, offsets, device):
    offs = list(offsets) + [0] * (MAX_OFFSETS - len(offsets))
    fault = (entry + "_fault", _planted) if _planted else (entry,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(fault[0])(*[t.data_ptr() for t in tensors], *ints, *offs, *fault[1:], stream)
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(entry, rc))


def _check_band(name, values, x, n_slots, packed):
    """values (O, R, b, b) planes or (R, b, (2r+1) b) packed rows against x
    (R b, F), of one dtype, float32, bfloat16 or float16; on CUDA only 128-row tiles
    and at most MAX_OFFSETS planes."""
    _check_common(name, (values, x), ())
    if x.dim() != 2:
        raise ValueError("{} takes x (n, F), got {}".format(name, tuple(x.shape)))
    if packed:
        ok = values.dim() == 3 and values.shape[2] == n_slots * values.shape[1]
        nb, block = (values.shape[0], values.shape[1]) if values.dim() == 3 else (0, 0)
    else:
        ok = values.dim() == 4 and values.shape[0] == n_slots and values.shape[2] == values.shape[3]
        nb, block = (values.shape[1], values.shape[2]) if values.dim() == 4 else (0, 0)
    if not ok or x.shape[0] != nb * block:
        raise ValueError("{} shape mismatch: values {}, {} slots, x {}".format(
            name, tuple(values.shape), n_slots, tuple(x.shape)))
    if x.device.type == "cuda":
        if values.data_ptr() % 16:
            raise ValueError("{} reads the tiles as float4: their storage must be 16-byte aligned".format(name))
        if block != BLOCK:
            raise ValueError("the {0} kernel takes {1}x{1} tiles, got {2}".format(name, BLOCK, block))
        if not packed and n_slots > MAX_OFFSETS:
            raise ValueError("the {} kernel takes at most {} offsets, got {}".format(name, MAX_OFFSETS, n_slots))
    return nb


def _check_dv(name, dy, x, n_slots, packed):
    """dy and x (R 128, F) alike, float32, bfloat16 or float16; on CUDA at most
    MAX_OFFSETS planes."""
    _check_common(name, (dy, x), ())
    if dy.shape != x.shape or x.dim() != 2 or x.shape[0] % BLOCK:
        raise ValueError("{} shape mismatch: dy {}, x {}".format(name, tuple(dy.shape), tuple(x.shape)))
    if x.device.type == "cuda" and not packed and n_slots > MAX_OFFSETS:
        raise ValueError("the {} kernel takes at most {} offsets, got {}".format(name, MAX_OFFSETS, n_slots))
    return x.shape[0] // BLOCK


def _offsets(offsets):
    return tuple(int(o) for o in np.asarray(offsets).reshape(-1))


def _dtype_code(dtype):
    """csrc/band_spmm.cu's code of a dtype: 0 float32, 1 bfloat16, 2 float16."""
    if dtype not in DTYPES:
        raise TypeError("the band kernels write float32, bfloat16 or float16, not {}".format(dtype))
    return DTYPES.index(dtype)


def _count(fn, dtype):
    """One launch of wrapper `fn` on operands of `dtype`."""
    if dtype == torch.float16:
        fn.f16_launches += 1
    else:
        fn.launches += 1


def _launch_spmm(values, x, nb, n_slots, radius, packed, transposed, offsets):
    out = torch.empty_like(x)
    if out.numel():
        _launch("band_spmm_launch", (values, x, out),
                (nb, x.shape[1], n_slots, radius, int(packed), int(transposed), _dtype_code(x.dtype)),
                offsets, x.device)
    return out


def _launch_dv(dy, x, nb, n_slots, radius, packed, offsets, out_dtype):
    shape = (nb, BLOCK, n_slots * BLOCK) if packed else (n_slots, nb, BLOCK, BLOCK)
    out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if out.numel():
        _launch("band_dv_launch", (dy, x, out),
                (nb, x.shape[1], n_slots, radius, int(packed), _dtype_code(x.dtype), _dtype_code(out_dtype)),
                offsets, x.device)
    return out


def band_spmm(band_values, offsets, x):
    """B7: y = A_band x on planes, (N_pad, F) in x's dtype. band_values (O, R, b, b),
    offsets host ints (O,), x (R b, F). CPU tensors take the plain version;
    CUDA tensors launch csrc/band_spmm.cu or raise."""
    offsets = _offsets(offsets)
    nb = _check_band("band_spmm", band_values, x, len(offsets), False)
    if x.device.type == "cpu":
        return band_plain(band_values, offsets, x, block=band_values.shape[2])
    out = _launch_spmm(band_values, x, nb, len(offsets), band_radius(offsets), False, False, offsets)
    _count(band_spmm, x.dtype)
    return out


def band_spmm_packed(v_pack, radius: int, x):
    """B8: y = A_band x on packed rows (R, b, (2 radius + 1) b)."""
    radius = int(radius)
    nb = _check_band("band_spmm_packed", v_pack, x, 2 * radius + 1, True)
    if x.device.type == "cpu":
        return band_packed_plain(v_pack, radius, x, block=v_pack.shape[1])
    out = _launch_spmm(v_pack, x, nb, 2 * radius + 1, radius, True, False, ())
    _count(band_spmm_packed, x.dtype)
    return out


def band_dx(band_values, offsets, dy):
    """B9 dX: dx = A_band^T dy on planes, written straight into (N_pad, F)."""
    offsets = _offsets(offsets)
    nb = _check_band("band_dx", band_values, dy, len(offsets), False)
    if dy.device.type == "cpu":
        return band_dx_plain(band_values, offsets, dy, block=band_values.shape[2])
    out = _launch_spmm(band_values, dy, nb, len(offsets), band_radius(offsets), False, True, offsets)
    _count(band_dx, dy.dtype)
    return out


def band_dx_packed(v_pack, radius: int, dy):
    """B9 dX's kernel reading the packed rows: dx = A_band^T dy."""
    radius = int(radius)
    nb = _check_band("band_dx_packed", v_pack, dy, 2 * radius + 1, True)
    if dy.device.type == "cpu":
        return band_dx_packed_plain(v_pack, radius, dy, block=v_pack.shape[1])
    out = _launch_spmm(v_pack, dy, nb, 2 * radius + 1, radius, True, True, ())
    _count(band_dx_packed, dy.dtype)
    return out


def band_dv(dy, x, offsets, out_dtype=None):
    """B9 dV: dV[o, r] = dy[r] x[r + o]^T, (O, R, 128, 128) in out_dtype (the
    values' dtype; default x's), zero tiles where r + o falls outside the
    graph."""
    offsets = _offsets(offsets)
    nb = _check_dv("band_dv", dy, x, len(offsets), False)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return band_dv_plain(dy, x, offsets, out_dtype=out_dtype)
    out = _launch_dv(dy, x, nb, len(offsets), band_radius(offsets), False, offsets, out_dtype)
    _count(band_dv, x.dtype)
    return out


def band_dv_packed(dy, x, radius: int, out_dtype=None):
    """B9 dV's kernel writing the packed layout (R, 128, (2 radius + 1) 128)."""
    radius = int(radius)
    nb = _check_dv("band_dv_packed", dy, x, 2 * radius + 1, True)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return band_dv_packed_plain(dy, x, radius, out_dtype=out_dtype)
    out = _launch_dv(dy, x, nb, 2 * radius + 1, radius, True, (), out_dtype)
    _count(band_dv_packed, x.dtype)
    return out


for _fn in (band_spmm, band_spmm_packed, band_dx, band_dx_packed, band_dv, band_dv_packed):
    _fn.launches = _fn.f16_launches = 0


# ---------------------------------------------------------------- autograd
class _BandSpMM(torch.autograd.Function):
    """y = A_band x on planes (``radius`` None) or packed rows; the values and
    x differentiable. A term whose input needs no gradient is skipped, as
    XLA drops it from the JAX program (the model's static band values).
    The values are cast to x's dtype here, as JAX's _band_apply casts them
    (band.py:678), and dV is returned in the values' own dtype (band.py:736)."""

    @staticmethod
    def forward(ctx, values, x, offsets, radius):
        ctx.offsets, ctx.radius = offsets, radius
        ctx.values_dtype, ctx.x_dtype = values.dtype, x.dtype
        values = values.to(x.dtype)
        need_v, need_x = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        ctx.save_for_backward(values if need_x else None, x if need_v else None)
        if radius is None:
            return band_spmm(values, offsets, x)
        return band_spmm_packed(values, radius, x)

    @staticmethod
    def backward(ctx, dy):
        values, x = ctx.saved_tensors
        dy = dy.to(ctx.x_dtype).contiguous()  # JAX rounds dy to x's dtype (band.py:623,727)
        packed = ctx.radius is not None
        dvalues = dx = None
        if ctx.needs_input_grad[1]:
            dx = band_dx_packed(values, ctx.radius, dy) if packed else band_dx(values, ctx.offsets, dy)
        if ctx.needs_input_grad[0]:
            vdt = ctx.values_dtype
            dvalues = band_dv_packed(dy, x, ctx.radius, vdt) if packed else band_dv(dy, x, ctx.offsets, vdt)
        return dvalues, dx, None, None


def spmm_band(band_values, offsets, x):
    """Y = A_band X from per-offset planes (O, R, b, b); `offsets` the host
    array of block offsets. Differentiable in band_values and x."""
    offsets = _offsets(offsets)
    if not offsets:
        return torch.zeros_like(x)
    return _BandSpMM.apply(band_values, x, offsets, None)


def spmm_band_packed(v_pack, radius: int, x):
    """Y = A_band X from packed rows (R, b, (2 radius + 1) b) (the serving
    form of graph_band_packed). Differentiable in v_pack and x. The rows are
    cast to x's dtype before the product, as JAX casts them (band.py:587),
    so their gradient is rounded to x's dtype on its way back."""
    return _BandSpMM.apply(v_pack.to(x.dtype), x, (), int(radius))
