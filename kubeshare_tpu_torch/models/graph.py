"""A step captured once as a CUDA graph and replayed: the port's
counterpart of the reference's jitted steps (``jax.jit`` of a training
step, of ``DecodeServer``'s decode step, of the serving bench's decode).
One replay launches the whole step, so pods that share the interpreter
lock spend no host time on the step's hundreds of small launches.

One recipe for every graphed step of the port:

- ``warmup`` runs twice on the capture stream before the capture, so that
  cuBLAS, cuDNN and autograd set themselves up and every kernel the step
  launches is loaded outside the capture. It must leave the state the
  step reads as it found it;
- a graph replays on the stream it was captured on: the caller's
  current stream, or, where that is the default stream (which cannot
  capture), a side stream drawn for the graph and joined to the
  caller's stream both ways at every replay. cuBLAS gives each (handle,
  stream) pair a workspace of its own and a graph keeps the one of its
  capture stream, so graphs that share a workspace share a stream and
  run one after another. Four pods' int8 decode graphs captured on one
  stream and replayed at once on four hung the card; without cuBLAS's
  workspace the same capture replays at once and agrees with each pod
  alone (``tests/test_torch_runtime_cuda.py``). A pod therefore makes
  its first call, the capture, on its own stream;
- the capture runs with ``capture_error_mode="thread_local"``: other
  threads (co-located pods, an executor's dispatcher) may go on using
  the card meanwhile;
- a generator the step draws from is registered with the graph, so each
  replay draws fresh numbers and advances it as an eager step would.

A graph replays fixed addresses: every tensor the step reads or writes
between replays is written in place, never rebound. A failed capture
raises; nothing falls back to eager.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

WARMUP_RUNS = 2


def capture(step: Callable[[], object],
            warmup: Optional[Callable[[], object]] = None,
            generators: Sequence[torch.Generator] = ()
            ) -> Tuple["torch.cuda.CUDAGraph", object, "torch.cuda.Stream"]:
    """Capture ``step()`` (it takes no arguments: it reads and writes
    tensors it holds) on the current CUDA device. Returns ``(graph,
    output, stream)``: ``graph.replay()`` on ``stream``, the capture
    stream, runs the step and rewrites ``output`` in place."""
    current = torch.cuda.current_stream()
    stream = current
    if current == torch.cuda.default_stream():
        stream = torch.cuda.Stream()
        stream.wait_stream(current)
    if warmup is not None:
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_RUNS):
                warmup()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        output = step()
    current.wait_stream(stream)
    return graph, output, stream


def restoring(step: Callable[[], object],
              state: Sequence[torch.Tensor]) -> Callable[[], None]:
    """A warm-up made of ``step`` itself: the step, then ``state`` (the
    tensors it updates that later steps read) put back as it was. Any
    other tensor the step writes must be one the captured step writes
    again before it is read (a decode step's K/V write at the cache's
    length)."""
    def warmup() -> None:
        saved = [t.clone() for t in state]
        step()
        for t, s in zip(state, saved):
            t.copy_(s)
    return warmup


class Replay:
    """``step()`` captured at its first call and replayed at every call
    when ``graphed`` (``capture``, with ``warmup`` and ``generators``),
    else run eager. Returns the step's output: with a graph, the
    graph's output buffer, rewritten by the next call. ``graph`` and
    ``stream`` are the captured graph and its capture stream (None
    before the first call, or when eager); a call from another stream
    replays on ``stream``, ordered after the caller's work and before
    its next. The step should hold the tensors it works on, not the
    object that owns this ``Replay``: a cycle would keep that object,
    and its device memory, until the garbage collector runs."""

    def __init__(self, step: Callable[[], object],
                 warmup: Optional[Callable[[], object]] = None,
                 generators: Sequence[torch.Generator] = (),
                 graphed: bool = True):
        self._step = step
        self._warmup = warmup
        self._generators = generators
        self.graphed = graphed
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.stream: Optional["torch.cuda.Stream"] = None
        self.output = None

    def __call__(self):
        if not self.graphed:
            self.output = self._step()
            return self.output
        if self.graph is None:
            self.graph, self.output, self.stream = capture(
                self._step, self._warmup, self._generators)
        current = torch.cuda.current_stream()
        if current == self.stream:
            self.graph.replay()
        else:
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.graph.replay()
            current.wait_stream(self.stream)
        return self.output


class GraphedStep:
    """``step(*inputs) -> output`` captured at its first call and
    replayed at every call. The inputs are copied into the graph's input
    buffers (``inputs``), unless they are those buffers; the output
    returned is the graph's output buffer, rewritten by the next call.
    ``warmup(*inputs)`` as in :func:`capture`."""

    def __init__(self, step: Callable, warmup: Callable):
        self._step = step
        self._warmup = warmup
        self._replay: Optional[Replay] = None
        self.inputs: Optional[Tuple[torch.Tensor, ...]] = None

    def __call__(self, *args: torch.Tensor):
        if self._replay is None:
            step, warmup = self._step, self._warmup
            self.inputs = inputs = tuple(a.clone() for a in args)
            self._replay = Replay(lambda: step(*inputs),
                                  lambda: warmup(*inputs))
        for static, given in zip(self.inputs, args):
            if given is not static:
                static.copy_(given)
        return self._replay()
