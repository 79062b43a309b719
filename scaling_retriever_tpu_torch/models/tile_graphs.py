"""CUDA graphs of the encoder's inference tile (no counterpart in the JAX
package, where ``jit`` plays this part).

An eager serving tile runs ~50 PyTorch ops a layer, then the LM head, the
pooling's vocabulary chunks and the top-T: ~1,500 launches at 28 layers,
each paying Python and the dispatcher on the host while the card waits.
``TileGraphs`` captures a tile function (ids and mask on the device to
(terms int32, vals f32) [w, T]) once for each (width, rung, T) shape and
replays it for every later tile of that shape: the eager forward's
kernels, in its order, from one host launch.

A shape is captured only inside ``capture_tiles()`` (the text frontend's
warm-up), right after one eager pass of it, on a CUDA device with grad
off: that pass builds what a capture may not, such as the model's rope
tables (``llama.RopeTables``), which the graph then reads. Every other
call runs the tile eagerly: shapes never warmed, calls with grad on,
calls on the CPU.

    with torch.no_grad(), capture_tiles():
        graphs.run(fn, ids, mask, t, device)   # eager pass, then capture
    with torch.no_grad():
        graphs.run(fn, ids, mask, t, device)   # one replay

A graph reads the weights where they lay when it was captured: updates in
place show in its replays, while a weight or adapter replaced by another
tensor after the capture needs a new ``TileGraphs``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

from scaling_retriever_tpu_torch.utils.profiling import profile_span, tracing

_local = threading.local()   # .capture: inside capture_tiles(); .replays


@contextlib.contextmanager
def capture_tiles():
    """Let ``TileGraphs.run`` capture the shapes it meets on this thread."""
    before = getattr(_local, "capture", False)
    _local.capture = True
    try:
        yield
    finally:
        _local.capture = before


def replays() -> int:
    """Tiles replayed from a graph on this thread so far."""
    return getattr(_local, "replays", 0)


class _Tile:
    """One captured shape: the graph and its static inputs and outputs."""

    __slots__ = ("graph", "ids", "mask", "out")

    def __init__(self, graph, ids, mask, out):
        self.graph, self.ids, self.mask, self.out = graph, ids, mask, out

    def replay(self, ids, mask) -> tuple:
        with profile_span("encoder.upload"):
            self.ids.copy_(torch.as_tensor(ids))
            self.mask.copy_(torch.as_tensor(mask))
        width, rung = self.ids.shape
        # the tile's real positions, summed from the host's mask only while
        # a profiler session records the span
        tokens = None
        if tracing():
            host = torch.as_tensor(mask)
            tokens = int(host.sum()) if host.device.type == "cpu" else None
        with profile_span("encoder.graph", width=width, rung=rung,
                          tokens=tokens):
            self.graph.replay()
            # fresh tensors: the next replay rewrites the static outputs
            out = tuple(x.clone() for x in self.out)
        _local.replays = replays() + 1
        return out


class TileGraphs:
    """An encoder's captured tiles, keyed by (width, rung, t). They share
    one memory pool, since replays run one after another on one stream;
    the graphs and the pool are freed with this object, which the encoder
    owns."""

    def __init__(self):
        self._tiles: dict = {}
        self._pool = None
        self._stream = None

    def __len__(self) -> int:
        return len(self._tiles)

    def run(self, fn: Callable, ids, mask, t: int,
            device: torch.device) -> tuple:
        """``fn(ids, mask)`` for one tile of host ids and mask [w, rung]:
        replayed where this (w, rung, t) was captured and grad is off,
        else run eagerly (and then captured, inside ``capture_tiles()`` on
        a CUDA device with grad off). ``fn`` takes host arrays or device
        tensors and returns a tuple of tensors."""
        key = (*ids.shape, t)
        tile = self._tiles.get(key)
        graphable = device.type == "cuda" and not torch.is_grad_enabled()
        if tile is not None and graphable:
            return tile.replay(ids, mask)
        if (tile is not None or not graphable
                or not getattr(_local, "capture", False)):
            return fn(ids, mask)
        out = fn(ids, mask)
        self._tiles[key] = self._capture(fn, ids, mask, device)
        return out

    def _capture(self, fn, ids, mask, device) -> _Tile:
        static_ids = torch.as_tensor(ids).to(device, copy=True)
        static_mask = torch.as_tensor(mask).to(device, copy=True)
        graph = torch.cuda.CUDAGraph()
        # as ``torch.cuda.graph`` captures, less its emptying of the
        # allocator's caches first (it made an H100's warm-up of the Qwen2
        # text tiles ~1.7 s slower, and leaves serving to allocate afresh);
        # one side stream, so each capture reuses the blocks the last one
        # freed in the pool; thread_local, since other threads may run
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            graph.capture_begin(self._pool, capture_error_mode="thread_local")
            try:
                out = fn(static_ids, static_mask)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self._pool = graph.pool()
        return _Tile(graph, static_ids, static_mask, out)
