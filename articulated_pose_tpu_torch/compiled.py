"""Captured programs: the port's counterpart of `jax.jit` on the card.

JAX hands XLA one program a call: `jax.jit(f)` compiles f once for each
input shape and then runs that executable (`serving.py:99-109`,
`train/state.py:102-140`, `data/device_synthetic.py:233-262` of the JAX
package).  The port runs its functions eagerly, one host launch an op;
`compiled(fn)` is its counterpart of `jax.jit(fn)`.  On the card it
captures fn once for each input signature as a `torch.cuda.CUDAGraph`
and then replays it with one host call.

- Arguments are a tree (tuples, lists, dicts) whose tensor leaves are
  the program's inputs.  Every other leaf (a module, a train state, a
  generator, an int) is part of the signature, by value where it is a
  number, string, dtype or device and otherwise by identity, and is kept
  alive by the program.  The signature is those leaves and the inputs'
  shapes, dtypes and devices, as XLA keeps one executable a shape.
- First call of a signature: fn runs eagerly on a side stream, which
  builds the kernels (`ops/kernels/build.py` builds inside a kernel's
  first call) and makes cuBLAS's handles; that run is the call's
  answer.  Then fn is captured on the same stream, reading static input
  buffers.  A capture runs no kernel, so a train step's in-place update
  is made once, by the first run.
- Later calls copy the inputs into the buffers and replay.  The outputs
  are cloned, so a later replay never overwrites a returned result (JAX
  returns fresh arrays).
- A `torch.Generator` leaf is registered with the graph, which reads the
  generator's seed and offset when it replays: a host-side
  `manual_seed` before a call gives the replay the draws that the eager
  call would make, and advances the generator as that call would.
- Launch counts: the kernel entries count their launches in Python
  (`ops/kernels/fps.py`, `ball_query.py`, `three_nn.py`), so a replay
  counts nothing by itself.  The capture's counts are taken back (it
  launched nothing) and added again on every replay, so the counts say
  how often each kernel ran.

On the CPU fn runs as it is: there are no graphs, and the caller asked
for the CPU.  On the card a failed capture or replay raises; no path
runs the eager body in its place.  A replay runs no Python: a
`TorchDispatchMode` (`roofline.count`) sees none of its ops, and
torch.profiler sees its kernels on the card but none of the
"kernel:<entry>" ranges of `CudaKernel.scope()`.  So the tools that count
or name ops run the eager body (`jit=False`).

What a trace does see: the "program.capture" span around a signature's
first call and "program.replay" around each later one (the inputs'
copy, the launch and the outputs' clones).  Inside the graph the body's
`utils/profiling.stage` marks stand: the capture records a timing event
at the body's start and at each mark, so every replay records them on
the card, and `stage_ms()` reads the last replay's stages in device ms.
`captures` counts the signatures built and `Captured.replays` each
one's replays.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from articulated_pose_tpu_torch.ops.kernels import KERNELS, launch_counts
from articulated_pose_tpu_torch.utils.profiling import span, stage, staging

# leaves of these types enter the signature by value
_BY_VALUE = (bool, int, float, str, type(None), torch.dtype, torch.device)


class CardGraphs:
    """How a program warms up and captures on the card: one side stream a
    device and `torch.cuda.CUDAGraph`s.  The tests put a stand-in's
    methods in place of these four."""

    def __init__(self):
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def applies(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def warm_up(self, device: torch.device, body: Callable[[], Any]) -> Any:
        """body() on the side stream, ordered after the work queued on the
        current stream and before the work queued after it."""
        side = self._stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = body()
        current.wait_stream(side)
        return out

    def capture(self, device: torch.device, body: Callable[[], Any],
                generators: List[torch.Generator]) -> Tuple[Any, Any, int]:
        """(graph, body's outputs, bytes the graph's pool reserved) of body
        captured on the side stream, `generators` registered."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # no garbage collection while capturing: a collection could free a
        # dropped program's graph, and tearing a graph down is a call the
        # capture forbids, which voids it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device):
                with torch.cuda.graph(graph, stream=self._stream(device)):
                    reserved = torch.cuda.memory_reserved(device)
                    out = body()
                    reserved = torch.cuda.memory_reserved(device) - reserved
        finally:
            if collecting:
                gc.enable()
        return graph, out, reserved

    def event(self, device: torch.device) -> torch.cuda.Event:
        """A timing event recorded on the side stream; during a capture,
        an event-record node of the graph, recorded at each replay."""
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record(self._stream(device))
        return ev


@dataclasses.dataclass
class Captured:
    """One signature's graph: its static input buffers and outputs, the
    kernel launches one replay stands for, and what the capture cost."""

    graph: Any
    inputs: List[torch.Tensor]
    outputs: Any
    launches: Dict[str, int]
    statics: List[Any]              # the signature's objects, kept alive
    capture_s: float
    pool_bytes: int
    stages: List[Tuple[str, Any]]   # ("start" or a stage mark, its event)
    replays: int = 0


def _device(leaves) -> Optional[torch.device]:
    """The one device of the tensor and generator leaves (None when there
    is none); leaves on two devices raise.  A generator made for "cuda"
    lies on the current card."""
    def placed(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    devices = {placed(x.device) for x in leaves
               if isinstance(x, (torch.Tensor, torch.Generator))}
    if len(devices) > 1:
        raise ValueError(f"a compiled program's arguments lie on one "
                         f"device, got {sorted(map(str, devices))}")
    return devices.pop() if devices else None


def _signature(leaves, spec) -> Hashable:
    def key(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), x.dtype, x.device)
        if isinstance(x, _BY_VALUE):
            return ("value", type(x), x)
        return ("object", id(x))
    return spec, tuple(map(key, leaves))


def _clone(tree):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class Program:
    """`fn` captured once a signature on the card and replayed; `fn` as
    it is on the CPU (see the module docstring).  `captured` holds each
    signature's `Captured`; `captures` counts them as they are built."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs = CardGraphs()
        self.captured: Dict[Hashable, Captured] = {}
        self.captures = 0
        self._last: Optional[Captured] = None

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        device = _device(leaves)
        if device is None:
            raise ValueError("a compiled program needs a tensor or a "
                             "generator among its arguments to know its "
                             "device")
        if not self.graphs.applies(device):
            return self.fn(*args)
        key = _signature(leaves, spec)
        entry = self.captured.get(key)
        if entry is None:
            with span("program.capture"):
                return self._capture(key, leaves, spec, device)
        with span("program.replay"):
            return self._replay(entry, [x for x in leaves
                                        if isinstance(x, torch.Tensor)])

    def stage_ms(self) -> Dict[str, float]:
        """{stage: device ms} of the last replay, each stage mark's time
        after the one before it (the first after the replay's start),
        read once the last mark has passed on the card; {} before a
        replay or where the body marks no stage."""
        entry = self._last
        if entry is None or len(entry.stages) < 2:
            return {}
        entry.stages[-1][1].synchronize()
        return {name: a.elapsed_time(b) for (_, a), (name, b)
                in zip(entry.stages, entry.stages[1:])}

    def _capture(self, key, leaves, spec, device):
        """The first call of a signature: the eager run is its answer,
        then the capture."""
        out = self.graphs.warm_up(
            device, lambda: self.fn(*pytree.tree_unflatten(leaves, spec)))
        with torch.no_grad():
            inputs = [x.clone() for x in leaves
                      if isinstance(x, torch.Tensor)]
        buffers = iter(inputs)
        static = [next(buffers) if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        statics = [x for x in leaves if not isinstance(x, torch.Tensor)]
        generators = [x for x in statics if isinstance(x, torch.Generator)]
        stages = []

        def body():
            stage("start")
            return self.fn(*pytree.tree_unflatten(static, spec))

        before = launch_counts()
        t0 = time.perf_counter()
        try:
            with staging(lambda name: stages.append(
                    (name, self.graphs.event(device)))):
                graph, outputs, pool = self.graphs.capture(device, body,
                                                           generators)
        finally:
            # the capture queued its kernels and launched none of them
            launched = {k: n - before[k] for k, n in launch_counts().items()}
            for k, n in launched.items():
                KERNELS[k].launches -= n
        self.captured[key] = Captured(
            graph=graph, inputs=inputs, outputs=outputs, launches=launched,
            statics=statics, capture_s=time.perf_counter() - t0,
            pool_bytes=pool, stages=stages)
        self.captures += 1
        return out

    def _replay(self, entry: Captured, tensors: List[torch.Tensor]):
        with torch.no_grad():
            for buf, x in zip(entry.inputs, tensors):
                buf.copy_(x)
        entry.graph.replay()
        for k, n in entry.launches.items():
            KERNELS[k].launches += n
        entry.replays += 1
        self._last = entry
        return _clone(entry.outputs)


def compiled(fn: Callable) -> Program:
    """`jax.jit(fn)` for the card: see the module docstring."""
    return Program(fn)
