"""Step graphs: one CUDA graph of a hot-path step per shape bucket.

The port's counterpart of the reference's per-bucket ``jax.jit`` caches
(``Engine.jit_functions``). PyTorch dispatches every op of a step from
Python, and a decode step or a prefill chunk is hundreds of small ops: on
the card the step waits on the host, not on its kernels.
:class:`StepGraphs` captures a step once per bucket into a
``torch.cuda.CUDAGraph`` and replays it, so a step costs one launch from
the host. A paged engine keeps two caches: its decode step per table
bucket and its chunk prefill per (prefix-page bucket x chunk bucket)
(``Engine.graph_functions``); the dense-slot engine and ``SsmEngine`` one
decode cache each. Each cache has its own memory pool; two caches of one
engine never replay at once (one stream), and each graph's static outputs
stay referenced by its cache, so no replay reuses another's outputs.

A step is a function of no arguments over *static* tensors that its owner
keeps at fixed addresses (staged inputs, the page pool, a decode state):
the owner writes a step's inputs into them, calls :meth:`StepGraphs.replay`
and reads the static outputs it returns before the next replay overwrites
them.

* **On a CUDA device** the first :meth:`StepGraphs.capture` of a key runs
  the step once eagerly on a side stream, as ``torch.cuda.graph`` wants (it
  builds each kernel's library at its first launch and sets its
  shared-memory attribute there, outside the capture), then captures it in
  one memory pool shared by every graph of the cache. The owner fills the
  static inputs with harmless values first: the eager run really executes.
  A capture that fails raises; nothing carries on eagerly.
* **On the CPU** an entry holds no graph: :meth:`replay` runs the step
  eagerly. The bucket bookkeeping is the same, so the capture budget of
  :mod:`repro_torch.analysis.compile_tracker` is testable without a card.
* **On a mesh of more than one device** (``capture=False``) an entry holds
  no graph either, whatever the device and the process group's backend:
  the step runs eagerly at every :meth:`replay`, and :attr:`captured`
  stays 0. A step there runs collectives, and one rule for every such
  mesh keeps the ranks' steps alike: a ``gloo`` collective cannot be
  captured at all, and capture under NCCL waits for a machine with two
  or more cards. This is the rule for such meshes, not a fallback after a
  failed capture.

A kernel wrapper runs only while a step is captured (its eager warm-up run
and the capture itself); a replay calls no wrapper, so a wrapper's launch
count does not see the kernels a replay runs. Count those on the device:
the paged and flash kernels count their own launches there
(``ops.KERNEL.device_launches``), and ``torch.profiler`` sees every
kernel.
"""
from __future__ import annotations

import time

import torch

from repro_torch.analysis import compile_tracker

#: one warm-up stream per device for every capture: each new stream that
#: runs a matmul gets its own cuBLAS workspace, held until the process ends
_WARMUP_STREAMS: dict = {}


def _warmup_stream() -> torch.cuda.Stream:
    idx = torch.cuda.current_device()
    if idx not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[idx] = torch.cuda.Stream()
    return _WARMUP_STREAMS[idx]


class StepGraphs:
    """A cache of captured steps keyed by bucket, for one engine."""

    def __init__(self, name: str, device: torch.device, capture: bool = True):
        self.name = name
        self.device = torch.device(device)
        self._capture = capture and self.device.type == "cuda"
        self._graphs: dict = {}            # key -> CUDAGraph
        self._outputs: dict = {}           # key -> the graph's static outputs
        self._steps: dict = {}             # key -> the step (CPU: run eagerly)
        self._pool = None                  # memory pool the graphs share
        self.replays = 0

    def __contains__(self, key) -> bool:
        return key in self._steps

    def keys(self) -> list:
        return list(self._steps)

    @property
    def captured(self) -> int:
        """CUDA graphs captured (0 on the CPU and on a mesh)."""
        return len(self._graphs)

    def cache_size(self) -> int:
        """Buckets captured: what the compile tracker budgets, as it read
        jit's ``_cache_size()``."""
        return len(self._steps)

    def capture(self, key, step) -> None:
        """Capture ``step`` (no arguments; returns its static outputs) as
        the entry for ``key``. On a CUDA device ``step`` runs once eagerly
        first, on whatever the static inputs hold; with ``capture=False``
        it is kept to run eagerly."""
        if key in self._steps:
            raise KeyError(f"{self.name}: bucket {key!r} is already captured")
        t0 = time.perf_counter()
        if self._capture:
            self._capture_cuda(key, step)
            step = None
        self._steps[key] = step
        compile_tracker.get_tracker().record(f"{self.name}[{key}]", time.perf_counter() - t0)

    def _capture_cuda(self, key, step) -> None:
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = _warmup_stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                step()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with torch.cuda.graph(graph, pool=self._pool):
                out = step()
        self._graphs[key] = graph
        self._outputs[key] = out

    def replay(self, key):
        """Run ``key``'s step: replay its graph and return its static
        outputs (on the CPU: run the step and return what it returns)."""
        self.replays += 1
        graph = self._graphs.get(key)
        if graph is None:
            return self._steps[key]()
        graph.replay()
        return self._outputs[key]
