"""A/B timing of two versions of the node-apply kernels on one GPU.

Builds ``csrc/node_apply_q8.cu`` (B2), ``csrc/node_apply_q8_t.cu`` (B2t),
``csrc/node_dots.cu`` (B11 A), ``csrc/node_factored.cu`` (B1 and B11 B) and
``csrc/node_factored_t.cu`` (B1t) of this checkout and of another one (e.g.
the parent commit unpacked with ``git archive``) with the port's nvcc
flags, loads both with ctypes (each pair shares one C interface:
``node_apply_q8_fwd``, ``node_apply_q8_t_bwd``, ``node_dots_fwd``,
``node_factored_fwd``, ``node_factored_t_bwd``) and times them in turns,
base, new, new, base, for several rounds:
  * B2 at the serving and training shapes (N=237, KI=320, gate O=128 and
    update O=64, at batches 1, 4 and 16) and at batch 256, and B2t at the
    training batch 16 and at 256, gate and update, each beside its library
    call (one torch.bmm on weights dequantized, or widened and transposed,
    to bf16 ahead of time, B2t's cotangent scaled and rounded ahead too);
  * B11 A and B11 B at the node-apply harness's shapes (T=24, B=16, NP=256,
    KI=320, O=192; B on 4,096 rows with D=20);
  * B1 and B1t at the flagship gate (O=128) and update (O=64) cells (B=16,
    K=5, N=237, I=64, D=20), bf16 and f32 operands.
B2 and B2t on f32 activations (the int8 stream at compute_dtype float32),
at B2's and B2t's shapes above, run only in this checkout, through its
``node_apply_q8_fwd_typed`` and ``node_apply_q8_t_bwd_typed``: each is held
against its plain version (rtol 1e-5, atol 1e-5 max|plain|) and timed in
the new turns of every round, beside its bf16 form (the ratio of the
medians is printed) and its library call (torch.bmm in f32, TF32 off, on
the weights widened to f32 ahead of time, B2's times the scale; B2t's on
the cotangent scaled and rounded to bf16 and widened ahead of time).
Before timing, each new output is held against the base's (one bf16 step
for a bf16 result, rtol 1e-5 with atol 1e-5 max|base| for an f32 one), and
B1's bf16 form and B11 B, whose kernel the f32 form's redesign left as it
was, must be the base's bit for bit (each new line says whether its output
is: ``identical``). The
unchanged layout-copy kernel (B3) is timed in each round as a control for
drift of the card, and the library call of B1 and B1t, one torch.einsum in
the operands' dtype, beside them; the order in which torch contracts each
(``tools.timing.einsum_order``) is printed with its FLOPs. Then, once a
round, each of B1's and B1t's bf16 tiles through ``node_factored_fwd_tile``
(192x32, 128x48, 128x32 and 128x16) and ``node_factored_t_bwd_tile``
(128x2, 128x1, 64x2 and 64x1, rows x k; each kernel takes one by the
grid), B1's f32 tiles (16 nodes x 32 o, the chunks of (k, i) split over 1,
2, 4 or 8 blocks of a cluster) through ``node_factored_fwd_tile``, B1t's
f32 tiles (16 nodes x 32 columns, O split over 1, 2, 4 or 8 blocks of a
cluster) through ``node_factored_t_bwd_tile``, and each of
B2's and B2t's batch tiles (wgmma's N = 8 to 128; on bf16 and on f32
activations) through ``node_apply_q8_fwd_typed`` and
``node_apply_q8_t_bwd_typed``, each
first held against the chosen tile's output. Times are
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
from multistgraph_tpu_torch.ops.node_apply import (_pad_nodes, factored_f32_tile_name, factored_t_f32_tile_name,
                                                   node_apply_q8_plain, node_apply_q8_t_plain,
                                                   pool_to_kernel_layout, quantize_node_weights)
from multistgraph_tpu_torch.tools.timing import card, einsum_order, event_ms

N, KI = 237, 320
GATES = (("gate", 128), ("update", 64))
B2_SHAPES = [(b, cell, o) for b in (1, 4, 16, 256) for cell, o in GATES]
B2T_SHAPES = [(b, cell, o) for b in (16, 256) for cell, o in GATES]
HARNESS = dict(T=24, B=16, NP=256, KI=320, O=192, D=20)
CELL = dict(B=16, K=5, N=237, I=64, D=20)
_P, _I = ctypes.c_void_p, ctypes.c_int
# source: (entry, argument types) of the interface both versions share
ENTRIES = {"node_apply_q8": ("node_apply_q8_fwd", [_P] * 4 + [_I] * 4 + [_P]),
           "node_apply_q8_t": ("node_apply_q8_t_bwd", [_P] * 4 + [_I] * 4 + [_P]),
           "node_dots": ("node_dots_fwd", [_P] * 4 + [_I] * 5 + [_P]),
           "node_factored": ("node_factored_fwd", [_P] * 5 + [_I] * 9 + [_P]),
           "node_factored_t": ("node_factored_t_bwd", [_P] * 4 + [_I] * 8 + [_P])}
# this checkout's entries with the tile (and, for B1t, B2 and B2t, no
# fault; for B2 and B2t bf16 operands) after the shared interface's int
# arguments: (entry, argument types, trailing ints)
Q8_TILES = (8, 16, 24, 32, 64, 128)
TILED = {"node_factored": ("node_factored_fwd_tile", [_P] * 5 + [_I] * 10 + [_P], ()),
         "node_factored_t": ("node_factored_t_bwd_tile", [_P] * 4 + [_I] * 10 + [_P], (0,)),
         "node_apply_q8": ("node_apply_q8_fwd_typed", [_P] * 4 + [_I] * 7 + [_P], (0, 0)),
         "node_apply_q8_t": ("node_apply_q8_t_bwd_typed", [_P] * 4 + [_I] * 7 + [_P], (0, 0))}
# the same entries' trailing ints for f32 operands
F32_TRAILING = {"node_apply_q8": (0, 1), "node_apply_q8_t": (0, 1)}
# each case's tiles: {tile: name}
B1_TILES = {0: "192x32", 1: "128x48", 2: "128x32", 3: "128x16"}
B1T_TILES = {0: "128x2", 1: "128x1", 2: "64x2", 3: "64x1"}
B1_F32_TILES = {t: factored_f32_tile_name(t) for t in range(4)}
B1T_F32_TILES = {t: factored_t_f32_tile_name(t) for t in range(4)}
Q8_TILE_NAMES = {t: "N={}".format(t) for t in Q8_TILES}


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


def _f32_cases(g, library):
    """[(kernel source, kernel, shape, pointer args, int args, output, plain
    output)] of B2 and B2t on f32 activations, with their library calls
    added to `library`."""
    cases = []
    for kernel, shapes in (("B2", B2_SHAPES), ("B2t", B2T_SHAPES)):
        for b, cell, o in shapes:
            act = torch.randn(N, b, o if kernel == "B2t" else KI, generator=g, device="cuda") * 0.1
            wq, s = quantize_node_weights(torch.randn(N, KI, o, generator=g, device="cuda") * 0.1)
            wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
            shape = "B={} {}".format(b, cell)
            if kernel == "B2":
                out = torch.empty(N, b, o, device="cuda")
                w32 = wq[:N].float()
                library[(kernel + " f32", shape)] = lambda act=act, w=w32, s=s: torch.bmm(act, w).mul_(s[:N])
                plain = node_apply_q8_plain(act, wq, s)
            else:
                out = torch.empty(N, b, KI, device="cuda")
                w_t = wq[:N].float().transpose(1, 2).contiguous()
                d_lib = (act * s[:N]).to(torch.bfloat16).float()
                library[(kernel + " f32", shape)] = lambda d=d_lib, w=w_t: torch.bmm(d, w)
                plain = node_apply_q8_t_plain(act, wq, s)
            cases.append(("node_apply_q8" if kernel == "B2" else "node_apply_q8_t", kernel + " f32", shape,
                          (act, wq, s, out), (N, b, KI, o), out, plain))
    return cases


def _cases(g):
    """[(kernel source, kernel, shape, pointer args, int args, output,
    {tile: name} of its tiles to time)] at the shapes the module docstring
    names, and
    {(kernel, shape): library call} for B1, B1t (the equation and operands
    of a torch.einsum), B2 and B2t (a callable)."""
    randn = lambda *s, dtype=torch.bfloat16: (torch.randn(*s, generator=g, device="cuda") * 0.1).to(dtype)
    cases = []
    library = {}
    for kernel, shapes in (("B2", B2_SHAPES), ("B2t", B2T_SHAPES)):
        for b, cell, o in shapes:
            act = randn(N, b, o if kernel == "B2t" else KI)
            wq, s = quantize_node_weights(randn(N, KI, o, dtype=torch.float32))
            wq, s = _pad_nodes(wq, 0, 256), _pad_nodes(s, 0, 256)
            shape = "B={} {}".format(b, cell)
            if kernel == "B2":
                out = torch.empty(N, b, o, device="cuda")
                w_deq = (wq[:N].float() * s[:N]).to(torch.bfloat16)
                library[(kernel, shape)] = lambda act=act, w=w_deq: torch.bmm(act, w)
            else:
                out = torch.empty(N, b, KI, dtype=torch.bfloat16, device="cuda")
                w_t = wq[:N].to(torch.bfloat16).transpose(1, 2).contiguous()
                d_lib = (act.float() * s[:N]).to(torch.bfloat16)
                library[(kernel, shape)] = lambda d=d_lib, w=w_t: torch.bmm(d, w)
            cases.append(("node_apply_q8" if kernel == "B2" else "node_apply_q8_t", kernel, shape,
                          (act, wq, s, out), (N, b, KI, o), out, Q8_TILE_NAMES))
    h = HARNESS
    scalar = torch.full((1, 1), 0.0123, device="cuda")
    hh = randn(h["T"], h["B"], h["NP"] * h["KI"])
    w = randn(h["NP"], h["KI"], h["O"])
    out = torch.empty(h["B"], h["NP"] * h["O"], dtype=torch.bfloat16, device="cuda")
    shape = "T={T} B={B} NP={NP} KI={KI} O={O}".format(**h)
    cases.append(("node_dots", "B11 A", shape, (hh, w, scalar, out),
                  (h["T"], h["B"], h["NP"], h["KI"], h["O"]), out, {}))
    rows = h["B"] * h["NP"]
    e_rows = randn(h["NP"], h["D"]).repeat(h["B"], 1).float()
    pool = randn(h["KI"], h["D"] * h["O"])
    out = torch.empty(rows, h["O"], dtype=torch.bfloat16, device="cuda")
    cases.append(("node_factored", "B11 B", shape + " D={D} rows".format(**h),
                  (hh.view(h["T"], rows, h["KI"]), e_rows, pool, scalar, out),
                  (h["T"], 1, 1, rows, h["KI"], h["D"], h["O"], 1, 1), out, {}))
    c = CELL
    for dtype in (torch.bfloat16, torch.float32):
        bf = int(dtype == torch.bfloat16)
        for cell, o in (("gate", 128), ("update", 64)):
            shape = "{} {}".format(cell, str(dtype)[6:])
            hh = randn(c["B"], c["K"], c["N"], c["I"], dtype=dtype)
            e = randn(c["N"], c["D"], dtype=torch.float32)
            mat, mat_t = pool_to_kernel_layout(randn(c["D"], c["K"], c["I"], o, dtype=dtype))
            out = torch.empty(c["B"], c["N"], o, device="cuda")
            cases.append(("node_factored", "B1", shape, (hh, e, mat, None, out),
                          (1, c["B"], c["K"], c["N"], c["I"], c["D"], o, bf, 0), out, B1_TILES if bf else B1_F32_TILES))
            library[("B1", shape)] = ("bkni,nd,kido->bno", hh, e.to(dtype), mat.view(c["K"], c["I"], c["D"], o))
            dpre = randn(c["B"], c["N"], o, dtype=dtype)
            e_t = e.to(dtype)
            dhh = torch.empty(c["B"], c["K"], c["N"], c["I"], dtype=dtype, device="cuda")
            cases.append(("node_factored_t", "B1t", shape, (dpre, e_t, mat_t, dhh),
                          (c["B"], c["K"], c["N"], c["I"], c["D"], o, bf, bf), dhh,
                          B1T_TILES if bf else B1T_F32_TILES))
            library[("B1t", shape)] = ("bno,nd,kdoi->bkni", dpre, e_t, mat_t.view(c["K"], c["D"], o, c["I"]))
    return cases, library


def _call(fn, ptrs, ints, stream, *extra):
    rc = fn(*[None if p is None else p.data_ptr() for p in ptrs], *ints, *extra, stream)
    if rc != 0:
        raise RuntimeError("launch failed: CUDA error {}".format(rc))


def _hold(got, ref, what):
    """One bf16 step for a bf16 result, rtol 1e-5 with atol 1e-5 max|ref| for f32."""
    got, want = got.float(), ref.float()
    if ref.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * (want.abs() + 1e-3 * want.abs().max())
    else:
        bound = 1e-5 * (want.abs() + want.abs().max())
    if not bool(((got - want).abs() <= bound).all()):
        raise AssertionError("{} differs from its reference".format(what))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=3)
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases, library = _cases(g)
    f32_cases = _f32_cases(g, library)
    view = torch.randn(24, 16, N, 192, generator=g, device="cuda")[..., :128]
    stream = torch.cuda.current_stream().cuda_stream
    samples, identical = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"base": _build(cli.base, tmp, "base"), "new": _build(here, tmp, "new")}
        fns = {(v, name): _fn(libs[v][name], *ENTRIES[name]) for v in libs for name in ENTRIES}
        tiled = {name: _fn(libs["new"][name], entry, types) for name, (entry, types, _) in TILED.items()}
        for source, kernel, shape, ptrs, ints, out, plain in f32_cases:
            for tile in (0,) + Q8_TILES:
                out.zero_()
                _call(tiled[source], ptrs, ints, stream, tile, *F32_TRAILING[source])
                torch.cuda.synchronize()
                _hold(out, plain, "{} {}: tile {} against its plain version".format(kernel, shape, tile or "chosen"))
        for source, kernel, shape, ptrs, ints, out, tiles in cases:
            # the new version against the base's output, then each of its
            # tiles against the chosen tile's
            _call(fns[("base", source)], ptrs, ints, stream)
            ref = out.clone()
            _call(fns[("new", source)], ptrs, ints, stream)
            torch.cuda.synchronize()
            _hold(out, ref, "{} {}: the new version".format(kernel, shape))
            identical[(kernel, shape)] = torch.equal(out, ref)
            unchanged = kernel == "B11 B" or (kernel == "B1" and "bfloat16" in shape)   # the bf16 B1 kernel's rows
            if unchanged and not identical[(kernel, shape)]:
                raise AssertionError("{} {}: the new version is not the base's bit for bit".format(kernel, shape))
            trailing = TILED[source][2] if tiles else ()
            for tile, tile_name in tiles.items():
                out.zero_()
                _call(tiled[source], ptrs, ints, stream, tile, *trailing)
                torch.cuda.synchronize()
                _hold(out, ref, "{} {}: tile {}".format(kernel, shape, tile_name))
        for _ in range(cli.rounds):
            for version in ("base", "new", "new", "base"):
                for source, kernel, shape, ptrs, ints, _, _ in cases:
                    fn = fns[(version, source)]
                    samples.setdefault((version, kernel, shape), []).append(
                        event_ms(lambda fn=fn, ptrs=ptrs, ints=ints: _call(fn, ptrs, ints, stream)))
                if version == "new":
                    for source, kernel, shape, ptrs, ints, _, _ in f32_cases:
                        samples.setdefault((version, kernel, shape), []).append(event_ms(
                            lambda fn=tiled[source], ptrs=ptrs, ints=ints, trailing=F32_TRAILING[source]:
                            _call(fn, ptrs, ints, stream, 0, *trailing)))
                samples.setdefault(("control", "B3", "gate_x (24,16,237,128) f32"), []).append(
                    event_ms(lambda: force_default_layout(view)))
            for (kernel, shape), call in library.items():
                if not callable(call):
                    equation, *operands = call
                    call = lambda equation=equation, operands=operands: torch.einsum(equation, *operands)
                samples.setdefault(("library", kernel, shape), []).append(event_ms(call))
            for source, kernel, shape, ptrs, ints, _, tiles in cases:
                trailing = TILED[source][2] if tiles else ()
                for tile, tile_name in tiles.items():
                    fn = tiled[source]
                    samples.setdefault(("new tile " + tile_name, kernel, shape), []).append(
                        event_ms(lambda fn=fn, ptrs=ptrs, ints=ints, tile=tile, trailing=trailing:
                                 _call(fn, ptrs, ints, stream, tile, *trailing)))
            for source, kernel, shape, ptrs, ints, _, _ in f32_cases:
                for tile in Q8_TILES:
                    samples.setdefault(("new tile " + Q8_TILE_NAMES[tile], kernel, shape), []).append(
                        event_ms(lambda fn=tiled[source], ptrs=ptrs, ints=ints, tile=tile,
                                 trailing=F32_TRAILING[source]: _call(fn, ptrs, ints, stream, tile, *trailing)))
    name = card()
    for (version, kernel, shape), ms in samples.items():
        line = {"version": version, "kernel": kernel, "shape": shape, "median_us": statistics.median(ms) * 1e3,
                "samples_us": [m * 1e3 for m in ms], "card": name}
        if version == "new" and (kernel, shape) in identical:
            line["identical"] = identical[(kernel, shape)]
        if version == "new" and kernel.endswith(" f32"):
            line["over_bf16_form"] = statistics.median(ms) / statistics.median(samples[("new", kernel[:-4], shape)])
        if version == "library" and kernel.endswith(" f32"):
            line.update(library="torch.bmm in f32 (TF32 off) on the int8 weights widened to f32 ahead of time "
                                "(B2: times the scale; B2t: transposed, on the cotangent scaled and rounded to "
                                "bf16 and widened ahead of time)")
        elif version == "library" and kernel in ("B2", "B2t"):
            line.update(library="torch.bmm on bf16 weights dequantized (B2) or widened and transposed (B2t, "
                                "beside the cotangent scaled and rounded) ahead of time")
        elif version == "library":
            equation, *operands = library[(kernel, shape)]
            line.update(library="torch.einsum('{}') in the operands' dtype".format(equation),
                        order=einsum_order(equation, *operands))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
