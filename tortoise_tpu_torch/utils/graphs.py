"""CUDA graphs of a module's repeated call (a diffusion step's forward, the
hybrid prior's decode step): the port's one place that captures and
replays them. A graph reads every tensor that is not one of its inputs
(parameters, a decode cache) where it lay at capture, so its owner calls
``Graphs.clear`` wherever that storage moves: in ``Module._apply``, which
``.to()`` and ``weights.cast_for_inference`` go through.
"""
from __future__ import annotations

import torch

from tortoise_tpu_torch.utils import profiling


class Graphs:
    """The CUDA graphs of one module's call, one per key, in one memory pool
    and captured on one side stream a device. Each capture runs inside span
    ``span``, its attributes named by ``dims`` after the first input's
    leading dimensions (names, not a function: a model holding this
    pickles). ``kernels`` are the hand-written kernels the call launches,
    each counting its launches in its ``launches`` attribute: a capture
    launches nothing, so each replay adds what the capture counted. One
    call at a time: a key's graph reuses its buffers."""

    def __init__(self, span: str, dims: tuple, *kernels):
        self.span = span
        self.dims = dims
        self.kernels = kernels
        self.captures = 0
        self.replays = 0
        self._graphs: dict = {}
        self._pool = None
        self._streams: dict = {}

    @staticmethod
    def eligible(module: torch.nn.Module, x: torch.Tensor) -> bool:
        """Whether ``module``'s call on ``x`` may take a graph: on the card,
        in eval mode, without grad and outside another capture."""
        return (x.is_cuda and not module.training and not torch.is_grad_enabled()
                and not torch.cuda.is_current_stream_capturing())

    def clear(self) -> None:
        """Drops every graph and the memory pool."""
        self._graphs.clear()
        self._pool = None

    def __call__(self, key, fn, inputs: tuple):
        """``fn(*inputs)``, the eager result bit for bit. The first call of
        ``key`` (and inference mode) runs ``fn`` eagerly, then captures it
        over copies of ``inputs``; a later call copies its inputs into the
        graph's, replays it and returns a copy of its output. ``inputs`` are
        tensors or None, the first a tensor on the graph's device; ``key``
        tells apart every two calls whose inputs differ in shape, dtype,
        stride or device, or whose ``fn`` differs."""
        key = (key, torch.is_inference_mode_enabled())
        entry = self._graphs.get(key)
        if entry is not None:
            graph, static, out, launches = entry
            for s, t in zip(static, inputs):
                if t is not None:
                    s.copy_(t)
            graph.replay()
            self.replays += 1
            for kernel, n in launches:
                kernel.launches += n
            return out.clone()
        # this call's result, and the warm-up of the kernels the capture records
        result = fn(*inputs)
        static = tuple(None if t is None else t.clone() for t in inputs)
        device = static[0].device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in self.kernels]
        with profiling.span(self.span, **dict(zip(self.dims, static[0].shape))), \
                torch.cuda.graph(graph, pool=self._pool, stream=self._streams[device],
                                 capture_error_mode="thread_local"):
            out = fn(*static)
        # the capture's kernel calls launched nothing: each replay counts them
        launches = [(k, k.launches - b) for k, b in zip(self.kernels, before)]
        for k, b in zip(self.kernels, before):
            k.launches = b
        self._graphs[key] = (graph, static, out, launches)
        self.captures += 1
        return result
