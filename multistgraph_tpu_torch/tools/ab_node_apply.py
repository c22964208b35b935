"""A/B timing of two versions of the node-apply kernels on one GPU.

Builds ``csrc/node_apply_q8.cu`` (B2), ``csrc/node_dots.cu`` (B11 A) and
``csrc/node_factored.cu`` (B1 and B11 B) of this checkout and of another
one (e.g. the parent commit unpacked with ``git archive``) with the port's
nvcc flags, loads both with ctypes (each pair shares one C interface:
``node_apply_q8_fwd``, ``node_dots_fwd``, ``node_factored_fwd``) and times
them in turns, base, new, new, base, for several rounds:
  * B2 at the serving and training shapes (N=237, KI=320, gate O=128 and
    update O=64, at batches 1, 4 and 16);
  * B11 A and B11 B at the node-apply harness's shapes (T=24, B=16, NP=256,
    KI=320, O=192; B on 4,096 rows with D=20);
  * B1 at the flagship gate (O=128) and update (O=64) cells (B=16, K=5,
    N=237, I=64, D=20), bf16 and f32 operands.
The unchanged layout-copy kernel (B3) is timed in each round as a control
for drift of the card. Then, once a round, each of B1's bf16 tiles
through ``node_factored_fwd_tile`` (192x32, 128x48, 128x32 and 128x16; the
kernel takes one by the grid), each first held against the chosen tile's
output (one bf16 step for a bf16 result, rtol 1e-5 with atol 1e-5
max|ref| for an f32 one). Times are
CUDA-event medians with the L2 flushed before each call
(``tools.timing.event_ms``, as chip_smoke.py takes them).

Run from the repository root:
    python -m multistgraph_tpu_torch.tools.ab_node_apply --base <dir of the other checkout>
Prints one JSON line per (version, kernel, shape) with the median over
rounds, and the card's name and power limit.
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
from multistgraph_tpu_torch.ops.layout import force_default_layout
from multistgraph_tpu_torch.ops.node_apply import _pad_nodes, pool_to_kernel_layout, quantize_node_weights
from multistgraph_tpu_torch.tools.timing import card, event_ms

N, KI = 237, 320
B2_SHAPES = [(b, cell, o) for b in (1, 4, 16) for cell, o in (("gate", 128), ("update", 64))]
HARNESS = dict(T=24, B=16, NP=256, KI=320, O=192, D=20)
CELL = dict(B=16, K=5, N=237, I=64, D=20)
_P, _I = ctypes.c_void_p, ctypes.c_int
# source: (entry, argument types) of the interface both versions share
ENTRIES = {"node_apply_q8": ("node_apply_q8_fwd", [_P] * 4 + [_I] * 4 + [_P]),
           "node_dots": ("node_dots_fwd", [_P] * 4 + [_I] * 5 + [_P]),
           "node_factored": ("node_factored_fwd", [_P] * 5 + [_I] * 9 + [_P])}
# this checkout's entries with the tile as the last int argument
TILED = {"node_factored": ("node_factored_fwd_tile", [_P] * 5 + [_I] * 10 + [_P], (0, 1, 2, 3))}
TILE_NAMES = {"node_factored": {0: "192x32", 1: "128x48", 2: "128x32", 3: "128x16"}}


def _build(root: str, out_dir: str, tag: str):
    """Each source of ENTRIES under `root`, one nvcc each, all started together."""
    procs = {}
    for name in ENTRIES:
        lib_path = os.path.join(out_dir, "lib{}-{}.so".format(name, tag))
        source = os.path.join(root, "multistgraph_tpu_torch", "csrc", name + ".cu")
        procs[name] = (lib_path, subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, source],
                                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for {} of {}:\n{}".format(name, root, out))
        libs[name] = ctypes.CDLL(lib_path)
    return libs


def _fn(lib, entry, argtypes):
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _cases(g):
    """[(kernel source, kernel, shape, pointer args, int args, output)] at the
    shapes the module docstring names."""
    randn = lambda *s, dtype=torch.bfloat16: (torch.randn(*s, generator=g, device="cuda") * 0.1).to(dtype)
    cases = []
    for b, cell, o in B2_SHAPES:
        hh = randn(N, b, KI)
        wq, s = quantize_node_weights(randn(N, KI, o, dtype=torch.float32))
        wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
        out = torch.empty(N, b, o, device="cuda")
        cases.append(("node_apply_q8", "B2", "B={} {}".format(b, cell), (hh, wq, s, out), (N, b, KI, o), out))
    h = HARNESS
    scalar = torch.full((1, 1), 0.0123, device="cuda")
    hh = randn(h["T"], h["B"], h["NP"] * h["KI"])
    w = randn(h["NP"], h["KI"], h["O"])
    out = torch.empty(h["B"], h["NP"] * h["O"], dtype=torch.bfloat16, device="cuda")
    shape = "T={T} B={B} NP={NP} KI={KI} O={O}".format(**h)
    cases.append(("node_dots", "B11 A", shape, (hh, w, scalar, out),
                  (h["T"], h["B"], h["NP"], h["KI"], h["O"]), out))
    rows = h["B"] * h["NP"]
    e_rows = randn(h["NP"], h["D"]).repeat(h["B"], 1).float()
    pool = randn(h["KI"], h["D"] * h["O"])
    out = torch.empty(rows, h["O"], dtype=torch.bfloat16, device="cuda")
    cases.append(("node_factored", "B11 B", shape + " D={D} rows".format(**h),
                  (hh.view(h["T"], rows, h["KI"]), e_rows, pool, scalar, out),
                  (h["T"], 1, 1, rows, h["KI"], h["D"], h["O"], 1, 1), out))
    c = CELL
    for dtype in (torch.bfloat16, torch.float32):
        for cell, o in (("gate", 128), ("update", 64)):
            hh = randn(c["B"], c["K"], c["N"], c["I"], dtype=dtype)
            e = randn(c["N"], c["D"], dtype=torch.float32)
            mat, _ = pool_to_kernel_layout(randn(c["D"], c["K"], c["I"], o, dtype=dtype))
            out = torch.empty(c["B"], c["N"], o, device="cuda")
            cases.append(("node_factored", "B1", "{} {}".format(cell, str(dtype)[6:]), (hh, e, mat, None, out),
                          (1, c["B"], c["K"], c["N"], c["I"], c["D"], o, int(dtype == torch.bfloat16), 0), out))
    return cases


def _call(fn, ptrs, ints, stream, *extra):
    rc = fn(*[None if p is None else p.data_ptr() for p in ptrs], *ints, *extra, stream)
    if rc != 0:
        raise RuntimeError("launch failed: CUDA error {}".format(rc))


def _hold(got, ref):
    """One bf16 step for a bf16 result, rtol 1e-5 with atol 1e-5 max|ref| for f32."""
    got, want = got.float(), ref.float()
    if ref.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    else:
        bound = 1e-5 * (want.abs() + want.abs().max())
    if not bool(((got - want).abs() <= bound).all()):
        raise AssertionError("a tile's output differs from the chosen tile's")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = _cases(g)
    view = torch.randn(24, 16, N, 192, generator=g, device="cuda")[..., :128]
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"base": _build(cli.base, tmp, "base"), "new": _build(here, tmp, "new")}
        fns = {(v, name): _fn(libs[v][name], *ENTRIES[name]) for v in libs for name in ENTRIES}
        tiled = {name: _fn(libs["new"][name], entry, types) for name, (entry, types, _) in TILED.items()}
        # each tile of this checkout against the chosen tile's output
        for source, kernel, shape, ptrs, ints, out in cases:
            if source not in TILED:
                continue
            _call(fns[("new", source)], ptrs, ints, stream)
            ref = out.clone()
            for tile in TILED[source][2]:
                if source == "node_factored" and ints[-2] == 0:
                    continue  # f32 operands: one tile
                out.zero_()
                _call(tiled[source], ptrs, ints, stream, tile)
                torch.cuda.synchronize()
                _hold(out, ref)
        samples = {}
        for _ in range(cli.rounds):
            for version in ("base", "new", "new", "base"):
                for source, kernel, shape, ptrs, ints, _ in cases:
                    fn = fns[(version, source)]
                    samples.setdefault((version, kernel, shape), []).append(
                        event_ms(lambda fn=fn, ptrs=ptrs, ints=ints: _call(fn, ptrs, ints, stream)))
                samples.setdefault(("control", "B3", "gate_x (24,16,237,128) f32"), []).append(
                    event_ms(lambda: force_default_layout(view)))
            for source, kernel, shape, ptrs, ints, _ in cases:
                if source not in TILED or (source == "node_factored" and ints[-2] == 0):
                    continue
                for tile in TILED[source][2]:
                    fn = tiled[source]
                    samples.setdefault(("new tile " + TILE_NAMES[source][tile], kernel, shape), []).append(
                        event_ms(lambda fn=fn, ptrs=ptrs, ints=ints, tile=tile: _call(fn, ptrs, ints, stream, tile)))
    name = card()
    for (version, kernel, shape), ms in samples.items():
        print(json.dumps({"version": version, "kernel": kernel, "shape": shape,
                          "median_us": statistics.median(ms) * 1e3, "samples_us": [m * 1e3 for m in ms],
                          "card": name}), flush=True)


if __name__ == "__main__":
    main()
