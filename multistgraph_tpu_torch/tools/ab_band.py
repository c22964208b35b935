"""A/B timing of two versions of the band kernels on one GPU.

Builds ``csrc/band_spmm.cu`` and ``csrc/band_probe.cu`` of this checkout
and of another one (e.g. the parent commit unpacked with ``git archive``)
with the port's nvcc flags, loads both with ctypes (they share one C
interface: ``band_spmm_launch``, ``band_dv_launch`` and
``band_slab_launch``) and times them in turns, base, new, new, base, for
several rounds, at the 1,000,000-node band of the bf16 path (7,813 row
blocks, diagonals -2..2, 39,059 tiles; random values, zero where a tile
falls outside the graph):
  * bf16 at every width the path gives each kernel: B7 (planes) at F = 24,
    128, 1536; B8 (packed rows) at F = 12, 64, 768 (bucket 1) and 24, 128,
    1536 (bucket 2); B9 dX (planes) and B9 dV (planes, bf16 values) at F =
    128 and 1536; and at widths that are no multiple of 8 beyond the path's
    F = 12, where the forward and dX take x by one bulk copy a chunk (B7
    and B9 dX at F = 12, 20; B8 at F = 3, 20, 36, the last by element
    loads);
  * f32 at the widths the 49,152-node f32 path gives each kernel: B7 at F =
    24, 128, 1536; B8 at F = 12, 64, 768, 24, 128, 1536; B9 dX and dV at F
    = 128, 1536;
  * with ``--dtype f16``: the f16 forms at the bf16 widths, beside the
    bf16 rows in turns (a base whose source takes no f16 operands skips
    them), each held within one f16 step of the new version's f32 form on
    the same operands widened to f32;
  * P2 ``band_slab`` (bf16 packed rows against the padded x, f32 out),
    per-row and batched, at the probe's point (R = 8,192 random row
    blocks, radius 2, F = 128) with chunk_rows 8 (P2) and 16 (P4's second
    slab);
  * P1 and P3 ``window_dot`` (f32) at the probe tool's shapes (P1: 4
    windows of 384 rows of a (1536, 128) stack, b = 128; P3: one window of
    640 rows at row 128 of a (1024, 128) x), each beside its library call
    (``torch.bmm`` of the stacked windows; ``v @ x[128:768]``) and an empty
    kernel of this checkout (``empty_launch``), the floor under a launch.
``--dtype`` keeps the rows of one operand type (f16 with bf16), ``--only``
the kernels whose name starts with one of its prefixes.
The unchanged layout-copy kernel (B3) is timed in each round as a control
for drift of the card. Before timing, each new output is held against the
base's: one bf16 step for bf16, rtol 1e-5 with atol 1e-5 max|base| for
f32 (the same products summed in another order), and each new row says
whether its output is the base's bit for bit on the same inputs
(``identical``; null where the base takes no such operands). Times are
CUDA-event medians with the L2 flushed before each call
(``tools.timing.event_ms``, as chip_smoke.py takes them).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.ab_band --base <dir of the other checkout>
Prints one JSON line per (version, kernel, shape) with the median over
rounds, the new rows' ``identical``, and the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import tempfile

import torch

from multistgraph_tpu_torch.ops import _cuda
from multistgraph_tpu_torch.ops.band import MAX_OFFSETS, pack_band_rows
from multistgraph_tpu_torch.ops.layout import force_default_layout
from multistgraph_tpu_torch.tools.timing import card, event_ms

BLOCK, ROW_BLOCKS, OFFSETS, RADIUS = 128, 7813, (-2, -1, 0, 1, 2), 2
SLAB_ROWS, SLAB_FEAT, SLAB_CHUNKS = 8192, 128, (8, 16)   # P2's point (tools/probe_band_stream.py)
BF16_WIDTHS = {"B7": (24, 128, 1536, 12, 20), "B8": (12, 64, 768, 24, 128, 1536, 3, 20, 36),
               "B9 dX": (128, 1536, 12, 20), "B9 dV": (128, 1536)}
F32_WIDTHS = {"B7": (24, 128, 1536), "B8": (12, 64, 768, 24, 128, 1536), "B9 dX": (128, 1536),
              "B9 dV": (128, 1536)}
_P, _I = ctypes.c_void_p, ctypes.c_int
# source: {entry: argument types} of the interface both versions share
ENTRIES = {"band_spmm": {"band_spmm_launch": [_P] * 3 + [_I] * (7 + MAX_OFFSETS) + [_P],
                         "band_dv_launch": [_P] * 3 + [_I] * (7 + MAX_OFFSETS) + [_P]},
           "band_probe": {"band_slab_launch": [_P] * 3 + [_I] * 5 + [_P],
                          "window_dot_launch": [_P] * 4 + [_I] * 4 + [_P]}}
WINDOWS = {"P1": (4, 128, 384, 128, (0, 384, 768, 1152), 4 * 384),   # (C, b, W, F, starts, rows of x)
           "P3": (1, 128, 640, 128, (128,), 1024)}


def _build(root: str, out_dir: str, tag: str):
    """{entry: function} of each source of ENTRIES under `root`, one nvcc
    each, both started together."""
    procs = {}
    for name in ENTRIES:
        lib_path = os.path.join(out_dir, "lib{}-{}.so".format(name, tag))
        source = os.path.join(root, "multistgraph_tpu_torch", "csrc", name + ".cu")
        procs[name] = (lib_path, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, source],
                                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib_path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for {} of {}:\n{}".format(name, root, out))
        lib = ctypes.CDLL(lib_path)
        for entry, argtypes in ENTRIES[name].items():
            fn = fns[entry] = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return fns


def _planes(g, dtype):
    """(5, R, 128, 128) random tiles, zero where r + o falls outside the graph."""
    v = torch.randn(len(OFFSETS), ROW_BLOCKS, BLOCK, BLOCK, generator=g, device="cuda").to(dtype)
    for i, o in enumerate(OFFSETS):
        if o < 0:
            v[i, :-o] = 0
        elif o > 0:
            v[i, ROW_BLOCKS - o:] = 0
    return v


CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}   # band_spmm.cu's dtype codes


def _cases(g, f16=False):
    """[(kernel, shape, entry, pointer args, int args, output)] at the shapes
    the module docstring names (and, with f16, the f16 rows), and
    {(kernel, shape): library call}."""
    cases, library = [], {}
    n = ROW_BLOCKS * BLOCK
    offs = list(OFFSETS) + [0] * (MAX_OFFSETS - len(OFFSETS))
    forms = ((torch.bfloat16, BF16_WIDTHS), (torch.float32, F32_WIDTHS)) + (
        ((torch.float16, BF16_WIDTHS),) if f16 else ())
    for dtype, widths in forms:
        planes = _planes(g, dtype)
        packed = pack_band_rows(planes, OFFSETS, RADIUS)
        dv_out = torch.empty_like(planes)
        code = CODES[dtype]
        operands = {}   # one x, dy and output per width, shared by the kernels
        for kernel, feats in widths.items():
            for feat in feats:
                if feat not in operands:
                    operands[feat] = [torch.randn(n, feat, generator=g, device="cuda").to(dtype) for _ in range(2)]
                    operands[feat].append(torch.empty_like(operands[feat][0]))
                x, dy, out = operands[feat]
                shape = "F={} {}".format(feat, str(dtype)[6:])
                if kernel == "B9 dV":
                    out = dv_out
                    cases.append((kernel, shape, "band_dv_launch", (dy, x, out),
                                  [ROW_BLOCKS, feat, len(OFFSETS), RADIUS, 0, code, code] + offs, out))
                    continue
                values, n_slots, is_packed = (packed, 2 * RADIUS + 1, 1) if kernel == "B8" else (
                    planes, len(OFFSETS), 0)
                cases.append((kernel, shape, "band_spmm_launch", (values, x, out),
                              [ROW_BLOCKS, feat, n_slots, RADIUS, is_packed, int(kernel == "B9 dX"), code] + offs,
                              out))
    v_pack = torch.randn(SLAB_ROWS, BLOCK, (2 * RADIUS + 1) * BLOCK, generator=g, device="cuda").bfloat16()
    xp = torch.randn(SLAB_ROWS + 2 * RADIUS, BLOCK, SLAB_FEAT, generator=g, device="cuda").bfloat16()
    out = torch.empty(SLAB_ROWS, BLOCK, SLAB_FEAT, device="cuda")
    for chunk_rows in SLAB_CHUNKS:
        for batched in (0, 1):
            cases.append(("P2 batched" if batched else "P2 per-row",
                          "R={} F={} chunk_rows={} bf16".format(SLAB_ROWS, SLAB_FEAT, chunk_rows), "band_slab_launch",
                          (v_pack, xp, out), [SLAB_ROWS, SLAB_FEAT, 2 * RADIUS + 1, chunk_rows, batched], out))
    for kernel, (c, b, w, f, starts, rows) in WINDOWS.items():
        v = torch.randn(c, b, w, generator=g, device="cuda")
        x = torch.randn(rows, f, generator=g, device="cuda")
        out = torch.empty(c, b, f, device="cuda")
        shape = "C={} b={} W={} F={} float32".format(c, b, w, f)
        cases.append((kernel, shape, "window_dot_launch",
                      (v, x, torch.tensor(starts, dtype=torch.int32, device="cuda"), out), [c, b, w, f], out))
        library[(kernel, shape)] = (lambda v=v, x=x, c=c, w=w, f=f: torch.bmm(v, x.view(c, w, f))) if (
            kernel == "P1") else (lambda v=v, x=x: v[0] @ x[128:768])
    return cases, library


def _call(fns, entry, ptrs, ints, stream, check=True):
    """One launch; raises on a failed launch, or with check=False returns its code."""
    rc = fns[entry](*[p.data_ptr() for p in ptrs], *ints, stream)
    if rc != 0 and check:
        raise RuntimeError("{} failed: CUDA error {}".format(entry, rc))
    return rc


def _hold(got, ref, what):
    """One bf16 step for bf16; rtol 1e-5 with atol 1e-5 max|ref| for f32; for
    f16 one f16 step plus that f32 rule (the reference is the f32 form, whose
    sums the tensor cores' f32 accumulation leaves by up to ~1e-6 of the
    largest entry at F = 1536: chip_smoke.py's F16_DV_SUMS_REL)."""
    got, want = got.float(), ref.float()
    if ref.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    elif ref.dtype == torch.float16:
        bound = 2.0 ** -10 * (want.abs() + 1e-3 * want.abs().max()) + 1e-5 * (want.abs() + want.abs().max())
    else:
        bound = 1e-5 * (want.abs() + want.abs().max())
    if not bool(((got - want).abs() <= bound).all()):
        raise AssertionError("{}: the new version's output differs from its reference".format(what))


def _f32_reference(fns, entry, ptrs, ints, out, stream):
    """An f16 case run by the f32 form on its operands widened to f32, the
    result rounded to f16 once."""
    wide = [p.float() for p in ptrs[:2]] + [torch.empty(out.shape, device="cuda")]
    ints = list(ints)
    ints[5 if entry == "band_dv_launch" else 6] = 0
    if entry == "band_dv_launch":
        ints[6] = 0
    _call(fns, entry, wide, ints, stream)
    return wide[2].half()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10, help="timed calls per sample")
    ap.add_argument("--only", nargs="*", default=[""],
                    help="time only the kernels whose name starts with one of these (e.g. P1 P3)")
    ap.add_argument("--dtype", choices=("all", "bf16", "f32", "f16"), default="all",
                    help="time only rows of this type (f16: the f16 rows beside the bf16 ones)")
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    g = torch.Generator(device="cuda").manual_seed(0)
    dtype = {"all": ("",), "f32": ("float32",), "bf16": ("bf",), "f16": ("bf", "float16")}[cli.dtype]
    cases, library = _cases(g, f16=cli.dtype == "f16")   # P2's shapes end in "bf16"
    cases = [case for case in cases if case[0].startswith(tuple(cli.only))
             and any(d in case[1].split()[-1] for d in dtype)]
    library = {key: call for key, call in library.items() if key[0] in {case[0] for case in cases}}
    view = torch.randn(24, 16, 237, 192, generator=g, device="cuda")[..., :128]
    stream = torch.cuda.current_stream().cuda_stream
    samples = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"base": _build(cli.base, tmp, "base"), "new": _build(here, tmp, "new")}
        empty = ctypes.CDLL(os.path.join(tmp, "libband_probe-new.so")).empty_launch
        empty.argtypes, empty.restype = [_P], ctypes.c_int
        identical, base_skips = {}, set()
        for kernel, shape, entry, ptrs, ints, out in cases:
            if _call(libs["base"], entry, ptrs, ints, stream, check=out.dtype != torch.float16):
                base_skips.add((kernel, shape))   # the base's source takes no f16 operands
                base_bits = None
            else:
                base_bits = out.clone()
            ref = _f32_reference(libs["new"], entry, ptrs, ints, out, stream) if (
                out.dtype == torch.float16) else base_bits
            _call(libs["new"], entry, ptrs, ints, stream)
            torch.cuda.synchronize()
            _hold(out, ref, "{} {}".format(kernel, shape))
            identical[("new", kernel, shape)] = None if base_bits is None else torch.equal(out, base_bits)
            del ref, base_bits
        for _ in range(cli.rounds):
            for version in ("base", "new", "new", "base"):
                lib = libs[version]
                for kernel, shape, entry, ptrs, ints, out in cases:
                    if version == "base" and (kernel, shape) in base_skips:
                        continue
                    samples.setdefault((version, kernel, shape), []).append(event_ms(
                        lambda entry=entry, ptrs=ptrs, ints=ints: _call(lib, entry, ptrs, ints, stream),
                        reps=cli.reps))
                samples.setdefault(("control", "B3", "gate_x (24,16,237,128) f32"), []).append(
                    event_ms(lambda: force_default_layout(view)))
            for (kernel, shape), call in library.items():
                samples.setdefault(("library", kernel, shape), []).append(event_ms(call, reps=cli.reps))
            if library:
                samples.setdefault(("floor", "empty kernel", "1 block of 32 threads"), []).append(
                    event_ms(lambda: empty(stream), reps=cli.reps))
    name = card()
    for (version, kernel, shape), ms in samples.items():
        print(json.dumps({"version": version, "kernel": kernel, "shape": shape,
                          "median_us": statistics.median(ms) * 1e3, "samples_us": [m * 1e3 for m in ms],
                          "identical": identical.get((version, kernel, shape)), "card": name}), flush=True)


if __name__ == "__main__":
    main()
