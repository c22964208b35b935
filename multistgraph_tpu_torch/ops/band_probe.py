"""The band-stream probes' kernels: ``window_dot`` (P1, P3) and ``band_slab`` (P2).

Counterpart of the three Pallas kernels of tools/probe_band_stream.py,
which probe how a slab-granular band SpMM can be built (the JAX package's
finished form of it is B8, ops/band.py:band_fwd_slab_pallas):

  * ``window_dot(v, x, starts)``: out[c] = v[c] @ x[starts[c] : starts[c] + W],
    v (C, b, W), x (rows, F), f32. P1 (``probe_batched_dot``, a batched
    dot (C,b,W) @ (C,W,F)) is the windows starts = (0, W, 2W, ...) of the
    (C W, F) stack; P3 (``probe_slice_reshape``, v @ x[1:6].reshape(640,
    128)) is one window at row 128 of x viewed as (1024, 128). The TPU
    kernels probe whether Mosaic lowers a batched dot and a reshape of a
    ref slice; the port computes the same products, not Mosaic's steps.
  * ``band_slab(v_pack, xp, radius, chunk_rows, batched)``: out[r] =
    v_pack[r] @ xp[r : r + 2 radius + 1].reshape((2 radius + 1) b, F), the
    packed rows (R, b, (2 radius + 1) b) against the zero-padded x
    (R + 2 radius, b, F), both bf16, f32 out: P2 (``probe_streams``) in
    its two variants, per-row products and one batched product per slab.

Both are hand-written CUDA in csrc/band_probe.cu, whose header gives the
design (``window_dot``: the window split into slices, one block each, the
blocks of an output tile a cluster that sums its partials in slice order
through distributed shared memory; ``band_slab`` on the tensor cores:
wgmma fed by TMA under the 128-byte swizzle). Each wrapper launches its
kernel for CUDA tensors and counts the launch (``window_dot.launches``; ``band_slab.launches`` for the
per-row variant, ``band_slab.batched_launches`` for the batched one), and
raises on what the kernel does not take, a TMA view that
cuTensorMapEncodeTiled refuses included; for CPU tensors it takes its
plain version (``window_dot_plain``: the einsum "cbw,cwf->cbf" over the
windows; ``band_slab_plain``: the stacked einsum of the probe's reference
form on the packed rows, in f32).
``planted_fault`` plants a fault in either kernel for the checks that must
fail it; ``slab_tile`` reads the feature tile a launch of ``band_slab``
takes, ``window_plan`` the tile rows and slices of one of ``window_dot``;
``empty_launch`` launches an empty kernel, the floor under a launch's time.
"""

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

from multistgraph_tpu_torch.ops import _cuda

BLOCK = 128
# Faults band_slab's kernel plants on request, for checks that must fail it
# (chip_smoke.py): the k16 slice holding each row block's last contraction
# element dropped; each window read one row block late.
FAULTS = {"k16": 1, "late": 2}
# ... and window_dot's: the last slice's partial left out of the sums.
WINDOW_FAULTS = {"slice": 1}
_planted = 0
_window_planted = 0


# ----------------------------------------------------------- plain versions
def window_dot_plain(v, x, starts: Sequence[int]):
    """einsum("cbw,cwf->cbf") of v against the stacked windows of x."""
    w = v.shape[2]
    return torch.einsum("cbw,cwf->cbf", v, torch.stack([x[s:s + w] for s in starts]))


def band_slab_plain(v_pack, xp, radius: int):
    """The stacked einsum "rijw,jrwf->rif" (the probe's "orij,orjf->rif" on
    the packed view) over the 2 radius + 1 windows of xp, in f32."""
    nb, block, width = v_pack.shape
    n_off = 2 * radius + 1
    xs = torch.stack([xp[j:j + nb] for j in range(n_off)]).float()
    return torch.einsum("rijw,jrwf->rif", v_pack.float().reshape(nb, block, n_off, block), xs)


# ------------------------------------------------------------ CUDA wrappers
@functools.cache
def _lib():
    lib = _cuda.library("band_probe")
    lib.window_dot_launch_plan.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.window_dot_plan.argtypes = [ctypes.c_int] * 4
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.band_slab_launch_fault.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.band_slab_tile.argtypes = [ctypes.c_int] * 4
    for fn in (lib.window_dot_launch_plan, lib.window_dot_plan, lib.empty_launch, lib.band_slab_launch_fault,
               lib.band_slab_tile):
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def planted_fault(kind: str):
    """Launch band_slab's kernel with the fault FAULTS[kind], or
    window_dot's with WINDOW_FAULTS[kind], planted in it while the block
    runs (CPU tensors take their plain versions, which carry none)."""
    global _planted, _window_planted
    if kind in WINDOW_FAULTS:
        _window_planted = WINDOW_FAULTS[kind]
    else:
        _planted = FAULTS[kind]
    try:
        yield
    finally:
        _planted = _window_planted = 0


def slab_tile(feat: int, radius: int, chunk_rows: int, batched: bool) -> int:
    """The feature tile (wgmma N) band_slab's kernel takes at these
    dimensions, 0 where it takes none; read from csrc/band_probe.cu."""
    return _lib().band_slab_tile(int(feat), 2 * int(radius) + 1, int(chunk_rows), int(batched))


def window_plan(c: int, b: int, w: int, f: int):
    """(tile rows, slices) a launch of window_dot takes at these dimensions
    on this card, read from csrc/band_probe.cu."""
    code = _lib().window_dot_plan(int(c), int(b), int(w), int(f))
    return code // 256, code % 256


def empty_launch(device="cuda"):
    """Launch an empty kernel of one warp on the device's current stream:
    the least time a launch takes, beside which window_dot's is read."""
    rc = _lib().empty_launch(_stream(torch.device(device)))
    if rc != 0:
        raise RuntimeError("empty kernel launch failed: CUDA error {}".format(rc))


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _check(name, tensors, dtype):
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("{} takes {} operands, got {}".format(name, dtype, [str(t.dtype) for t in tensors]))
    if len({t.device for t in tensors}) != 1 or tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError("{} takes operands on one CPU or CUDA device".format(name))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("{} takes contiguous tensors".format(name))


@functools.lru_cache(maxsize=None)
def _device_starts(starts, device):
    """The window starts as an int32 tensor on `device`, copied there once."""
    return torch.tensor(starts, dtype=torch.int32, device=device)


def window_dot(v, x, starts: Sequence[int]):
    """out[c] = v[c] @ x[starts[c] : starts[c] + W]: v (C, b, W), x (rows, F)
    float32, `starts` C host ints with every window inside x; (C, b, F)
    float32. CPU tensors take the plain version; CUDA tensors launch
    csrc/band_probe.cu or raise."""
    _check("window_dot", (v, x), torch.float32)
    starts = tuple(int(s) for s in starts)
    if v.dim() != 3 or x.dim() != 2 or len(starts) != v.shape[0]:
        raise ValueError("window_dot takes v (C, b, W), x (rows, F) and C starts, got {}, {}, {}".format(
            tuple(v.shape), tuple(x.shape), len(starts)))
    c, b, w = v.shape
    if any(s < 0 or s + w > x.shape[0] for s in starts):
        raise ValueError("window_dot: a window of {} rows at {} leaves x's {} rows".format(w, starts, x.shape[0]))
    if x.device.type == "cpu":
        return window_dot_plain(v, x, starts)
    out = torch.empty((c, b, x.shape[1]), dtype=torch.float32, device=x.device)
    rc = _lib().window_dot_launch_plan(v.data_ptr(), x.data_ptr(), _device_starts(starts, x.device).data_ptr(),
                                       out.data_ptr(), c, b, w, x.shape[1], 0, 0, _window_planted,
                                       _stream(x.device))
    if rc != 0:
        raise RuntimeError("window_dot kernel launch failed: CUDA error {}".format(rc))
    window_dot.launches += 1
    return out


def band_slab(v_pack, xp, radius: int, chunk_rows: int = 8, batched: bool = False):
    """out[r] = v_pack[r] @ xp[r : r + 2 radius + 1].reshape(W, F): v_pack
    (R, 128, W = (2 radius + 1) 128) and xp (R + 2 radius, 128, F) bfloat16,
    (R, 128, F) float32. `chunk_rows` row blocks per slab (any R; the last
    slab may be short); `batched` picks the variant. On CUDA F must be a
    multiple of 8 (the window comes by TMA in 16-byte units) and both
    operands 16-byte aligned (else the launch fails)."""
    _check("band_slab", (v_pack, xp), torch.bfloat16)
    radius, chunk_rows = int(radius), int(chunk_rows)
    n_off = 2 * radius + 1
    if v_pack.dim() != 3 or xp.dim() != 3 or v_pack.shape[2] != n_off * v_pack.shape[1] \
            or xp.shape[:2] != (v_pack.shape[0] + 2 * radius, v_pack.shape[1]) or chunk_rows < 1:
        raise ValueError("band_slab shape mismatch: v_pack {}, xp {}, radius {}, chunk_rows {}".format(
            tuple(v_pack.shape), tuple(xp.shape), radius, chunk_rows))
    if xp.device.type == "cpu":
        return band_slab_plain(v_pack, xp, radius)
    nb, block, feat = v_pack.shape[0], v_pack.shape[1], xp.shape[2]
    if block != BLOCK or feat % 8:
        raise ValueError("the band_slab kernel takes 128-row blocks and F a multiple of 8, got block {}, F {}".format(
            block, feat))
    out = torch.empty((nb, block, feat), dtype=torch.float32, device=xp.device)
    rc = _lib().band_slab_launch_fault(v_pack.data_ptr(), xp.data_ptr(), out.data_ptr(), nb, feat, n_off,
                                       chunk_rows, int(batched), _planted, _stream(xp.device))
    if rc != 0:
        raise RuntimeError("band_slab kernel launch failed: CUDA error {}".format(rc))
    if batched:
        band_slab.batched_launches += 1
    else:
        band_slab.launches += 1
    return out


window_dot.launches = 0
band_slab.launches = 0
band_slab.batched_launches = 0
