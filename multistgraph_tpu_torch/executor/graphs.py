"""CUDA graphs of the executor's and the service's steps.

Counterpart of the JAX package's compiled programs: the executor's train
step and epoch scan, its validation and prediction scans
(multistgraph_tpu/executor/executor.py:159-164) and the service's predict
program per batch bucket (multistgraph_tpu/serving.py:113-131). A
``StepGraph`` records one step's launches once and replays them as one
launch. Train, validation, predict and every serving bucket use it.

What a graph may read. A replay launches the kernels exactly as they were
recorded, with the same pointers; B2/B2t, B4/B6, B5 and B7-B9 even carry
TMA views of their operands as kernel parameters, encoded on the host at
capture (csrc/node_apply_q8.cuh, bsr_spmm.cu, sampled_matmul.cu,
band_spmm.cu). So a captured step reads only tensors that stay where they
are between replays: its static inputs (which the caller refills before
each replay), the model's parameters (updated in place) and buffers (the
graph arrays), the optimizer's state, the loader's device-resident split,
and what the step itself allocates (SpMM workspaces and counters too),
which lives in the graph's private memory pool and lands at the same
addresses on every replay. What the wrappers read on the host at capture
is baked in: a fault planted in a kernel (``planted_fault``) stays in or
out of a graph as it was when the graph was captured.

Warm-up. A step is captured only after it ran eagerly: the caller runs the
first real batches through ``on_side_stream`` (PyTorch's whole-network
recipe), which builds the kernels, sets their one-time statics (B2/B2t's
occupancy), creates the optimizer's state and cuBLAS's workspace. Capture
records without executing, so the first replay is the next real batch.

Launch accounting. The kernel wrappers count their launches in Python
attributes (``node_apply_q8.launches``, ...), which a replay does not
touch. During capture the wrappers run and count launches that have not
happened; ``StepGraph`` takes that change back out of the counters and
keeps it as ``captured``, so the counters go on counting launches only, and
``replayed_launches()`` gives what the replays launched.

Dropout. The generators a step draws from are registered with its graph
(``CUDAGraph.register_generator_state``): each replay draws the bits an
eager step would draw from the generator's current state and advances it
as the eager step would.

No fallback: a capture or replay that fails raises.
"""

import importlib
import types
from typing import Callable, Dict, Iterable, Tuple

import torch

# the port's modules whose kernel wrappers count their launches
_COUNTED_MODULES = ("band", "band_probe", "layout", "node_apply", "node_dots", "spmm", "stream_read")


def launch_counters() -> Dict[str, Tuple[object, str]]:
    """{"module.wrapper.attribute": (wrapper, attribute)} for every launch
    count of the port's kernel wrappers (each attribute whose name holds
    "launches")."""
    counters = {}
    for module_name in _COUNTED_MODULES:
        module = importlib.import_module("multistgraph_tpu_torch.ops." + module_name)
        for name, fn in vars(module).items():
            if (name.startswith("_") or not isinstance(fn, types.FunctionType)
                    or fn.__module__ != module.__name__):
                continue
            for attr, value in vars(fn).items():
                if "launches" in attr and isinstance(value, int):
                    counters["{}.{}.{}".format(module_name, name, attr)] = (fn, attr)
    return counters


def read_launches() -> Dict[str, int]:
    return {key: getattr(fn, attr) for key, (fn, attr) in launch_counters().items()}


def on_side_stream(fn: Callable, stream: torch.cuda.Stream):
    """fn() run eagerly on `stream`, ordered after the current stream's work
    and before what the current stream queues next."""
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


class StepGraph:
    """``fn()`` recorded once as a CUDA graph, in a memory pool of its own.

    `inputs` are the static tensors ``fn`` reads, which ``run`` refills;
    `generators` are the ``torch.Generator`` objects ``fn`` draws from.
    ``fn`` returns a tensor or a tuple of tensors: the graph owns them and
    each replay writes them anew.
    """

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor] = None,
                 generators: Iterable[torch.Generator] = ()):
        self.inputs = dict(inputs or {})
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self.graph.register_generator_state(generator)
        before = read_launches()
        with torch.cuda.graph(self.graph):
            self.outputs = fn()
        after = read_launches()
        counters = launch_counters()
        for key, count in before.items():
            setattr(*counters[key], count)
        self.captured = {key: after[key] - count for key, count in before.items() if after[key] != count}
        self.replays = 0

    def run(self, **inputs: torch.Tensor):
        """Copy each of `inputs` into the static input of that name, replay
        the graph, and return its outputs (valid until the next replay)."""
        for name, value in inputs.items():
            self.inputs[name].copy_(value)
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches of all replays so far, by counter."""
        return {key: count * self.replays for key, count in self.captured.items()}
