"""Captured graphs of the padded pure-decode and speculative steps.

``RealBackend.step`` makes one padded-layout model call a step: the plain
decode of gamma = 0, or the draft chain and the target's verify of
gamma > 0.  Its shapes follow from three values the step sees on the host:
the batch bucket ``Bb``, the block tables' width (a power of two, which
also fixes ``paged_attention``'s split plan and window span) and gamma.
:class:`StepGraphs` keeps one captured graph per such key and replays it,
so the host enqueues one graph launch instead of every kernel of the step.

* A capture costs about three eager steps (recording every kernel into
  the graph takes the host twice the eager enqueue, and instantiating it
  about once more), and it holds up every stream of its batch.  So graphs are captured before serving
  (``RealBackend.capture_steps``), at a few batch buckets (``buckets``:
  1, 4, 16, ... up to the largest, which a step pads its batch up to, as
  recording costs a kernel, not a row) and every gamma the engine may ask
  for, at one table width, ``width``, wide enough for the contexts the
  pool is sized for.  A step's graph is that of its bucket and gamma at
  the wider of ``width`` and its tables' width; narrower tables are
  padded with the write-off block: a split plan for the wider table costs
  a replay a few per cent, not a capture.  A key
  with no graph (tables wider than ``width``, or graphs dropped) captures
  at its first step.  So the keys are a few buckets x a few powers of two
  x the gammas, and the runner keeps them all.  Every graph allocates
  from one shared memory pool: replays never overlap, and a replay's
  outputs are read before the next replay.
* A graph reads its inputs from static buffers, which each step fills
  from the host (through pinned staging memory on the card), and leaves
  its outputs in static tensors.
* A graph holds the addresses of the parameters and page tensors it was
  captured over.  The backend drops its graphs whenever those move; a
  replay whose addresses no longer match raises instead of reading freed
  memory.
* ``paged_attention`` counts its launches in Python: a capture records
  what its launches added, and every replay adds that again.

The graph class is an argument: :class:`CudaGraph` on the card; the CPU
tests give a stand-in with the same three calls.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Hashable, Sequence, Tuple

import numpy as np
import torch

from ..kernels.paged_attention import paged_attention
from .paged_runtime import bucket_size

_ADDED = ("launches", "window_launches")     # counters a replay adds to
_LAST = ("last_splits",)                     # counters a replay sets


def graph_buckets(max_batch: int) -> Tuple[int, ...]:
    """The batch buckets graphs are captured at: the powers of four below
    ``max_batch``'s power-of-two bucket, and that bucket."""
    top, out = bucket_size(max_batch), [1]
    while out[-1] * 4 < top:
        out.append(out[-1] * 4)
    return tuple(out) + ((top,) if top > 1 else ())


def _counters() -> Dict[str, int]:
    return {a: getattr(paged_attention, a) for a in _ADDED + _LAST}


@contextmanager
def uncounted():
    """Leave ``paged_attention``'s counters as they were before the block:
    around a capture, which launches nothing, and a warm-up step, which
    serves nothing."""
    before = _counters()
    try:
        yield before
    finally:
        for a, v in before.items():
            setattr(paged_attention, a, v)


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the runner's calls: ``shared``
    makes what every graph of one runner shares (the memory pool and the
    side stream captures run on), ``capture`` records a callable's work on
    that stream, and ``replay`` launches it on the current stream.  A
    graph is instantiated at its first replay, not at its capture: the
    engine captures every step before serving, and a step that never
    runs costs only its recording."""

    def __init__(self, shared):
        self.pool, self.stream = shared
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.instantiated = False

    @staticmethod
    def shared(device):
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def capture(self, fn: Callable[[], tuple]) -> tuple:
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=self.pool)
            try:
                outs = fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture's own error is the one to raise
                raise
            self.graph.capture_end()
        cur.wait_stream(self.stream)
        return outs

    def replay(self) -> None:
        if not self.instantiated:
            self.graph.instantiate()
            self.instantiated = True
        self.graph.replay()


class _Entry:
    """One key's graph, its static inputs and host staging, its static
    outputs, the addresses it was captured over and what its launches add
    to the counters."""

    __slots__ = ("graph", "inputs", "staging", "outputs", "ptrs", "added",
                 "last")

    def __init__(self, inputs, staging):
        self.inputs, self.staging = inputs, staging
        self.graph = self.outputs = self.ptrs = None
        self.added = self.last = None


class StepGraphs:
    """One captured step per key, replayed; see the module's docstring."""

    def __init__(self, graph_cls, device, *, max_batch: int,
                 width: int = 1):
        self.graph_cls = graph_cls
        self.device = torch.device(device)
        self.buckets = graph_buckets(max_batch)
        self.width = width        # the narrowest table a graph is made at
        self.shared = graph_cls.shared(self.device)
        self.entries: Dict[Hashable, _Entry] = {}
        self.captures = 0
        self.replays = 0

    def bucket(self, n: int) -> int:
        """The batch bucket a step of ``n`` sequences runs at."""
        return next((b for b in self.buckets if b >= n), bucket_size(n))

    def key(self, n: int, width: int, gamma: int) -> Tuple[int, int, int]:
        """The graph a step of ``n`` sequences, tables ``width`` blocks
        wide and ``gamma`` runs: (batch bucket, graph width, gamma)."""
        return self.bucket(n), max(width, self.width), gamma

    def captured(self, key: Hashable) -> bool:
        e = self.entries.get(key)
        return e is not None and e.graph is not None

    def load(self, key: Hashable, arrays: Sequence[np.ndarray]) -> _Entry:
        """Fill ``key``'s static inputs (made on its first use) from the
        host ``arrays``, with copies that do not block the host."""
        e = self.entries.get(key)
        if e is None:
            pin = self.device.type == "cuda"
            staging = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                   pin_memory=pin) for a in arrays]
            e = self.entries[key] = _Entry(
                [torch.empty_like(h, device=self.device) for h in staging],
                staging)
        for host, dev, a in zip(e.staging, e.inputs, arrays):
            host.numpy()[...] = a
            dev.copy_(host, non_blocking=True)
        return e

    def capture(self, key: Hashable, arrays: Sequence[np.ndarray],
                ptrs: Tuple[int, ...], fn: Callable[..., tuple]) -> None:
        """Capture ``key``'s graph of ``fn`` over static inputs filled from
        ``arrays`` (any values of the step's shapes: a capture runs
        nothing), without replaying it."""
        entry = self.load(key, arrays)
        if entry.graph is None:
            self._capture(entry, ptrs, fn)

    def run(self, entry: _Entry, ptrs: Tuple[int, ...],
            fn: Callable[..., tuple]) -> tuple:
        """Replay ``entry``'s graph, capturing ``fn(*entry.inputs)`` (the
        step's model call, returning its output tensors) first if it has
        none; returns the static outputs.  ``ptrs`` are the addresses of
        the tensors the call reads and writes besides its inputs."""
        if entry.graph is None:
            self._capture(entry, ptrs, fn)
        elif entry.ptrs != ptrs:
            raise RuntimeError(
                "a captured step's parameters or page tensors moved without "
                "the backend dropping its graphs")
        before = _counters()
        entry.graph.replay()
        self.replays += 1
        for a in _ADDED:
            setattr(paged_attention, a, before[a] + entry.added[a])
        for a in _LAST:
            setattr(paged_attention, a, entry.last[a])
        return entry.outputs

    def _capture(self, entry: _Entry, ptrs, fn) -> None:
        graph = self.graph_cls(self.shared)
        with uncounted() as before:
            try:
                entry.outputs = graph.capture(lambda: fn(*entry.inputs))
            except BaseException:
                self.drop(lambda k: self.entries[k] is entry)
                raise
            after = _counters()
        entry.added = {a: after[a] - before[a] for a in _ADDED}
        entry.last = {a: after[a] for a in _LAST}
        entry.graph, entry.ptrs = graph, ptrs
        self.captures += 1

    def drop(self, which: Callable[[Hashable], bool] = lambda key: True
             ) -> None:
        """Drop the graphs whose key ``which`` takes (all by default).
        Once none is left the pool is released, and later captures take a
        new one."""
        for k in [k for k in self.entries if which(k)]:
            del self.entries[k]
        if not self.entries:
            self.shared = self.graph_cls.shared(self.device)
