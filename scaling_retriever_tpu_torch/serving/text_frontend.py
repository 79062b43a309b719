"""Text-in serving: a micro-batched query-encode stage in front of the
retrieval broker (port of serving/text_frontend.py).

Texts are coalesced into fixed-shape encoder tiles (a width ladder, and a
length ladder in the tokenizer), the SPLADE forward and the top-T
sparsification run on the device, and either

* the handoff path (``make_encode_fn_handoff`` over a segsort engine): the
  (terms, vals) tensors stay on the device and the retrieval program is
  dispatched directly behind the encoder; the only read per tile is the
  retrieval result, which carries each query's true job need, and rows
  over the standing job bucket re-route through ``server.submit``; or
* the host path (``make_encode_fn``): one packed read of the reps, then
  each rep goes through ``RetrievalServer.submit``.

Dispatch (tokenize + encode + retrieval dispatch) and resolve (read +
submit) run on two threads, handing tiles through a bounded queue whose
depth is the dispatch-ahead bound.

On a CUDA device ``warmup()`` captures each (width, length rung) tile as
one CUDA graph (``models/tile_graphs.py``), from the device-resident ids
and mask to the (terms, vals) handoff; the dispatch thread replays it for
every tile of a warmed shape, and forms each tile once the card has run
the last. Shapes not warmed, and the encoder's other callers, run the
tile eagerly.

Spans (``utils/profiling.py``): on the dispatch thread ``frontend.dispatch``
a tile (attrs: tile id, width, real rows, length rung) around
``frontend.tokenize``, the encoder's spans (a replayed tile:
``encoder.upload`` and ``encoder.graph``, attrs width, rung and the
tile's real positions ``tokens``) and
``engine.launch``; on the resolver ``frontend.pending`` (from the tile's
dispatch end until the resolver takes it), ``engine.read`` and
``frontend.deliver``. While a
profiler session runs every answered request leaves a
``frontend.request`` record from its submit to its result, with its id,
its tile, the tile's dispatch start (``dispatch_ns``) and ``rerouted``
for a row over the job bucket.
"""

from __future__ import annotations

import collections
import functools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from scaling_retriever_tpu_torch.models import tile_graphs
from scaling_retriever_tpu_torch.serving.server import LATENCY_WINDOW
from scaling_retriever_tpu_torch.utils.profiling import (profile_span,
                                                         record, tracing)

_STOP = object()


def load_sparse_encoder(model_dir: str,
                        lora_name_or_path: Optional[str] = None,
                        device="cuda", **config_overrides):
    """(model, tokenizer) from a checkpoint directory, with the eval CLIs'
    dispatch (``models.encoder.load_encoder``): ``model_type`` picks the
    encoder class, an ``adapter_config.json`` means a LoRA directory. The
    tokenizer is the directory's, loaded by ``transformers``."""
    from scaling_retriever_tpu_torch.models.encoder import (load_encoder,
                                                            load_tokenizer)

    model = load_encoder(model_dir, "sparse", lora_name_or_path,
                         device=device, **config_overrides)
    return model, load_tokenizer(model_dir)


def make_hf_tokenize_fn(tokenizer, max_length: int = 64,
                        lengths: Optional[Sequence[int]] = None) -> Callable:
    """Fixed-length tokenization for a tokenizer object with the HF call
    interface. ``lengths`` is a length ladder: a batch is padded to the
    smallest rung covering its longest query instead of ``max_length``.
    Reps do not depend on the rung: pads are masked, and with left padding
    the rung shifts every real token's position by a constant, which rope
    attention does not see."""
    if lengths is None:
        rungs = (max_length,)
    else:
        rungs = tuple(sorted({min(int(n), max_length) for n in lengths}
                             | {max_length}))

    def tokenize(texts: Sequence[str], length: Optional[int] = None):
        if length is None:
            probe = tokenizer(list(texts), truncation=True,
                              max_length=max_length, padding=False,
                              return_attention_mask=False)["input_ids"]
            need = max((len(x) for x in probe), default=1)
            length = next(r for r in rungs if r >= need)
        enc = tokenizer(list(texts), truncation=True, max_length=length,
                        padding="max_length", return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))

    tokenize.lengths = rungs
    return tokenize


def _encode_top_t(model, ids, mask, t: int):
    """Encode a tile and keep each row's top-``t`` (terms int32, vals f32);
    non-positive slots carry term 0 and weight 0 (unused)."""
    reps = model.encode(ids, mask)                       # [w, V] f32
    with profile_span("encoder.top_t"):
        vals, terms = torch.topk(reps, t, dim=1)
        vals = vals.clamp_min(0.0)
        terms = torch.where(vals > 0, terms, 0).to(torch.int32)
        return terms, vals


def _top_t(model, ids: np.ndarray, mask: np.ndarray, t: int):
    """``_encode_top_t`` through the encoder's tile graphs: replayed where
    ``warmup()`` captured the tile's shape, else eager."""
    return model.tile_graphs.run(
        functools.partial(_encode_top_t, model, t=t), ids, mask, t,
        model.device)


def make_encode_fn_handoff(model, t_sparse: int = 64) -> Callable:
    """Text-tile encoder for the device handoff: returns (terms, vals)
    [w, t_sparse] tensors on the model's device, for
    ``SegsortEngine.retrieve_tile_handoff_async``. No host read."""
    def dispatch(ids: np.ndarray, mask: np.ndarray):
        return _top_t(model, ids, mask, t_sparse)

    dispatch.dispatch = dispatch
    dispatch.handoff = True
    return dispatch


def make_encode_fn(model, t_sparse: int = 64) -> Callable:
    """Text-tile encoder for the host path: ONE packed [w, 2 * t_sparse]
    f32 array per tile, terms as exact f32 integers in ``[:, :t]`` (vocab
    ids < 2^24) and values in ``[:, t:2t]``. ``encode.dispatch`` enqueues
    without a host read; ``encode.read`` reads."""
    def dispatch(ids: np.ndarray, mask: np.ndarray):
        terms, vals = _top_t(model, ids, mask, t_sparse)
        return torch.cat([terms.float(), vals], dim=1)

    def read(packed) -> np.ndarray:
        return packed.cpu().numpy()

    def encode(ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return read(dispatch(ids, mask))

    encode.dispatch = dispatch
    encode.read = read
    return encode


def _recorded(handle) -> Optional[torch.cuda.Event]:
    """An event recorded behind the work queued so far on the card of a
    tile's handle ((terms, vals) or a packed tensor), or None off a card."""
    t = handle[0] if isinstance(handle, tuple) else handle
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def _fail(reqs: list, exc: Exception) -> None:
    for req in reqs:
        if not req[2].done():
            req[2].set_exception(exc)


def _note_request(req: tuple, tile, end_ns: int, rerouted: bool) -> None:
    """An answered request's record (kept while a profiler session
    runs)."""
    record("frontend.request", req[3], end_ns, id=req[4],
           tile=tile.attrs["tile"], dispatch_ns=tile.t0, rerouted=rerouted)


def _note_answered(req: tuple, tile, rerouted: bool, fut: Future) -> None:
    if fut.exception() is None:
        _note_request(req, tile, time.time_ns(), rerouted)


def _chain(inner: Future, fut: Future) -> None:
    """Resolve ``fut`` with ``inner``'s outcome."""
    def done(f):
        if fut.done():
            return
        exc = f.exception()
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(f.result())

    inner.add_done_callback(done)


class QueryEncoderFrontend:
    """Micro-batching broker for text queries: collect -> tokenize ->
    encode tile -> retrieval. ``submit_text`` returns a Future resolving
    to the same ``(doc_ids, scores)`` as the retrieval server.

    With a handoff encode fn the server's backend must wrap a segsort
    engine (``fetch == "dma"``). ``jobs_bucket`` is the standing job bucket
    of the handoff; None sizes it in ``warmup()`` (or from the first tile)
    as the sample's max need times ``bucket_headroom``, rounded up to 64.
    """

    def __init__(self, server, encode_fn: Callable, tokenize_fn: Callable,
                 widths: Sequence[int] = (8, 64), t_sparse: int = 64,
                 max_wait_ms: float = 2.0, pipeline_depth: int = 2,
                 jobs_bucket: Optional[int] = None,
                 bucket_headroom: float = 1.15):
        self.server = server
        self.encode_fn = encode_fn
        self.tokenize_fn = tokenize_fn
        self.widths = tuple(sorted(widths))
        self.t_sparse = t_sparse
        self.max_wait = max_wait_ms / 1e3
        engine = getattr(server.backend, "engine", None)
        self.handoff = bool(
            getattr(encode_fn, "handoff", False)
            and engine is not None
            and getattr(engine, "fetch", None) == "dma"
            and hasattr(engine, "retrieve_tile_handoff_async"))
        if getattr(encode_fn, "handoff", False) and not self.handoff:
            raise ValueError(
                "handoff encode fn needs a SparseTileBackend whose engine "
                "is a segsort engine (fetch='dma')")
        self.jobs_bucket = jobs_bucket
        self.bucket_headroom = float(bucket_headroom)
        self.n_handoff_tiles = 0
        self.n_fallback_queries = 0
        self.pipeline_depth = max(1, pipeline_depth)
        self._q: queue.Queue = queue.Queue()
        self._pending: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        self._thread: Optional[threading.Thread] = None
        self._resolver: Optional[threading.Thread] = None
        self._started = False
        self._lock = threading.Lock()
        self.n_texts = 0
        self.n_encode_batches = 0
        self.graph_tiles = 0        # tiles dispatched as a replayed graph
        self.eager_tiles = 0
        self.n_tiles = 0            # tiles dispatched, the tiles' ids
        self.encode_latencies_s = collections.deque(maxlen=LATENCY_WINDOW)
        self.rung_tiles: dict = {}  # (width, q_len) -> tile count
        self.stage_s = {"wait": 0.0, "tokenize": 0.0, "dispatch": 0.0,
                        "read": 0.0, "submit": 0.0}

    # -- lifecycle -------------------------------------------------------

    def _size_bucket(self, max_need: int) -> int:
        """Standing job bucket: need * headroom rounded up to a multiple of
        64 (keeps the slab a multiple of the rank tail's 4096-slot block)."""
        need = max(int(max_need * self.bucket_headroom), 1)
        return max(64, -(-need // 64) * 64)

    def _engine_need(self, handle) -> int:
        engine = self.server.backend.engine
        return int(engine.job_need(handle[0].cpu().numpy(),
                                   handle[1].cpu().numpy()).max(initial=0))

    @torch.no_grad()
    @tile_graphs.capture_tiles()
    def warmup(self, sample_texts: Sequence[str], passes: int = 3) -> dict:
        """Run every encoder (width, length rung) shape, and on the handoff
        path size the standing bucket from the sample and run its
        retrieval shapes, before serving. Call before ``start()``. On a
        CUDA device the encoder captures each shape as a graph after its
        first pass."""
        if self._started:
            raise RuntimeError("warm up before start()")
        t0 = time.perf_counter()
        n = 0
        max_need = 0
        rungs = getattr(self.tokenize_fn, "lengths", None)
        engine = getattr(self.server.backend, "engine", None)
        for w in self.widths:
            if not sample_texts:
                continue
            texts = (list(sample_texts) * -(-w // len(sample_texts)))[:w]
            for rung in (rungs if rungs else (None,)):
                if rung is None:
                    ids, mask = self.tokenize_fn(texts)
                else:
                    ids, mask = self.tokenize_fn(texts, length=rung)
                for _ in range(passes):
                    out = self.encode_fn(ids, mask)
                    n += 1
                if self.handoff:
                    max_need = max(max_need, self._engine_need(out))
        handoff_stats = {}
        if self.handoff:
            if self.jobs_bucket is None:
                self.jobs_bucket = self._size_bucket(max_need)
            n_r = 0
            for w in self.widths:
                if not sample_texts:
                    continue
                texts = (list(sample_texts) * -(-w // len(sample_texts)))[:w]
                handle = self.encode_fn(*self.tokenize_fn(texts))
                for _ in range(passes):
                    engine.finalize_handoff(
                        engine.retrieve_tile_handoff_async(
                            handle[0], handle[1], self.jobs_bucket,
                            topk=self.server.backend.topk))
                    n_r += 1
            handoff_stats = {"jobs_bucket": self.jobs_bucket,
                             "retrieve_warmup_tiles": n_r}
        return {"encode_warmup_s": round(time.perf_counter() - t0, 3),
                "encode_warmup_tiles": n, **handoff_stats}

    def start(self) -> "QueryEncoderFrontend":
        if self._thread is not None:
            raise RuntimeError("already started")
        self._started = True
        self._thread = threading.Thread(target=self._loop,
                                        name="encode-frontend", daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          name="encode-resolve", daemon=True)
        self._resolver.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self._q.put(_STOP)
        self._thread.join()          # forwards _STOP through _pending
        self._resolver.join()
        self._thread = None
        self._resolver = None
        while True:                  # fail raced submits, so none hangs
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item[2].set_exception(RuntimeError("encoder frontend stopped"))

    def __enter__(self) -> "QueryEncoderFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------

    def submit_text(self, text: str, topk: Optional[int] = None) -> Future:
        if not self._started:
            raise RuntimeError("frontend not started — a submit would hang")
        if not isinstance(text, str) or not text.strip():
            raise ValueError("text query must be a non-empty string")
        fut: Future = Future()
        with self._lock:
            self.n_texts += 1
            rid = self.n_texts
        # (text, topk, future, submit ns, request id)
        self._q.put((text, topk, fut, time.time_ns(), rid))
        return fut

    def search_text(self, text: str, topk: Optional[int] = None):
        return self.submit_text(text, topk).result()

    # -- worker ------------------------------------------------------------

    def _collect(self, first) -> list:
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.widths[-1]:
            remaining = deadline - time.perf_counter()
            try:
                item = self._q.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            batch.append(item)
            if item is _STOP:
                break
        return batch

    def _dispatch_batch(self, reqs: list):
        """Tokenize + enqueue one encode tile and, on the handoff path,
        the retrieval program behind it. Returns (reqs, width, ids, handle,
        rpayload, tile span) for ``_resolve_batch``, or None if dispatch
        failed (the batch's futures get the exception; serving
        continues)."""
        texts = [r[0] for r in reqs]
        width = next(w for w in self.widths if w >= len(texts))
        padded = texts + [texts[-1]] * (width - len(texts))
        dispatch = getattr(self.encode_fn, "dispatch", self.encode_fn)
        self.n_tiles += 1
        try:
            with profile_span("frontend.dispatch", tile=self.n_tiles,
                              width=width, rows=len(reqs)) as tile:
                with profile_span("frontend.tokenize") as tok:
                    ids, mask = self.tokenize_fn(padded)
                tile.attrs["rung"] = int(ids.shape[1])
                replayed = tile_graphs.replays()
                handle = dispatch(ids, mask)
                graphed = tile_graphs.replays() > replayed
                rpayload = None
                if self.handoff:
                    if self.jobs_bucket is None:
                        # unwarmed start: size the bucket from the first
                        # tile
                        self.jobs_bucket = self._size_bucket(
                            self._engine_need(handle))
                    rpayload = self.server.backend.engine \
                        .retrieve_tile_handoff_async(
                            handle[0], handle[1], self.jobs_bucket,
                            topk=self.server.backend.topk,
                            n_real=len(reqs))
            self.stage_s["tokenize"] += tok.seconds
            self.stage_s["dispatch"] += (tile.t1 - tok.t1) / 1e9
            with self._lock:
                self.graph_tiles += int(graphed)
                self.eager_tiles += int(not graphed)
        except Exception as e:  # fail this batch; keep serving
            _fail(reqs, e)
            return None
        return reqs, width, ids, handle, rpayload, tile

    def _count_tile(self, width: int, ids, handoff: bool) -> None:
        with self._lock:
            self.n_encode_batches += 1
            self.n_handoff_tiles += int(handoff)
            key = (width, int(ids.shape[1]))
            self.rung_tiles[key] = self.rung_tiles.get(key, 0) + 1

    def _resolve_batch(self, reqs: list, width: int, ids, handle,
                       rpayload, tile) -> None:
        record("frontend.pending", tile.t1, time.time_ns(),
               tile=tile.attrs["tile"])
        if rpayload is not None:
            self._resolve_handoff(reqs, width, ids, handle, rpayload, tile)
            return
        read = getattr(self.encode_fn, "read", None)
        t0 = time.time_ns()
        try:
            packed = read(handle) if read is not None else handle
        except Exception as e:
            _fail(reqs, e)
            return
        t = self.t_sparse
        self._count_tile(width, ids, False)
        traced = tracing()
        with profile_span("frontend.deliver", tile=tile.attrs["tile"]) as sp:
            for i, req in enumerate(reqs):
                _, topk, fut, t_sub, _ = req
                vals = packed[i, t:2 * t]
                keep = vals > 0
                terms = packed[i, :t][keep].astype(np.int32)
                try:
                    inner = self.server.submit((terms, vals[keep]), topk)
                except Exception as e:  # this request only, never co-riders
                    fut.set_exception(e)
                    continue
                with self._lock:
                    self.encode_latencies_s.append(
                        (time.time_ns() - t_sub) / 1e9)
                _chain(inner, fut)
                if traced:
                    fut.add_done_callback(functools.partial(
                        _note_answered, req, tile, False))
        self.stage_s["read"] += (sp.t0 - t0) / 1e9
        self.stage_s["submit"] += sp.seconds

    def _resolve_handoff(self, reqs: list, width: int, ids, handle,
                         rpayload, tile) -> None:
        """One read (the retrieval result, with each query's need).
        In-bucket rows resolve directly; over-bucket rows (truncated job
        table, partial scores) re-route through ``server.submit``."""
        backend = self.server.backend
        engine = backend.engine
        t0 = time.time_ns()
        try:
            scores, rows, need = engine.finalize_handoff(rpayload)
        except Exception as e:
            _fail(reqs, e)
            return
        self._count_tile(width, ids, True)
        traced = tracing()
        with profile_span("frontend.deliver", tile=tile.attrs["tile"]) as sp:
            results = backend._to_results(scores, rows, len(reqs))
            fb_terms = fb_vals = None
            for i, req in enumerate(reqs):
                _, topk, fut, t_sub, _ = req
                k = topk or backend.topk
                if int(need[i]) > self.jobs_bucket:
                    # truncated row: the only time this path reads the reps
                    if fb_terms is None:
                        fb_terms = handle[0].cpu().numpy()
                        fb_vals = handle[1].cpu().numpy()
                    keep = fb_vals[i] > 0
                    with self._lock:
                        self.n_fallback_queries += 1
                    try:
                        inner = self.server.submit(
                            (fb_terms[i][keep].astype(np.int32),
                             fb_vals[i][keep]), topk)
                    except Exception as e:
                        if not fut.done():
                            fut.set_exception(e)
                        continue
                    _chain(inner, fut)
                    if traced:
                        fut.add_done_callback(functools.partial(
                            _note_answered, req, tile, True))
                    continue
                ids_i, sc_i = results[i]
                now = time.time_ns()
                with self._lock:
                    # the full text -> result latency on this path
                    self.encode_latencies_s.append((now - t_sub) / 1e9)
                if not fut.done():
                    fut.set_result((ids_i[:k], sc_i[:k]))
                if traced:
                    _note_request(req, tile, now, False)
        self.stage_s["read"] += (sp.t0 - t0) / 1e9
        self.stage_s["submit"] += sp.seconds

    @torch.no_grad()
    def _loop(self) -> None:
        """Dispatch thread: collect -> tokenize -> dispatch ->
        ``_pending.put`` (a blocking put when the resolver is
        ``pipeline_depth`` tiles behind: texts pile up and the next tile
        forms full). Grad is off, so warmed tiles replay their graphs.

        The next tile forms once the card has run the last one, so that
        it takes in the texts that arrived meanwhile: its upload would wait
        for the card all the same, and a tile formed while the card is busy
        leaves them to the tile after."""
        ready = None
        while True:
            if ready is not None:
                ready.synchronize()
            t0 = time.perf_counter()
            item = self._q.get()
            self.stage_s["wait"] += time.perf_counter() - t0
            if item is _STOP:
                break
            batch = self._collect(item)
            stop = batch[-1] is _STOP
            if stop:
                batch = batch[:-1]
            if batch:
                dispatched = self._dispatch_batch(batch)
                if dispatched is not None:
                    ready = _recorded(dispatched[3])
                    self._pending.put(dispatched)
            if stop:
                break
        self._pending.put(_STOP)

    def _resolve_loop(self) -> None:
        """Resolve thread: drain tiles in dispatch order."""
        while True:
            item = self._pending.get()
            if item is _STOP:
                break
            try:
                self._resolve_batch(*item)
            except Exception as e:
                # fail this tile's futures; a dead resolver would wedge
                # the dispatch thread's put
                _fail(item[0], e)

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self.encode_latencies_s, np.float64)
            out = {"n_texts": self.n_texts,
                   "n_encode_batches": self.n_encode_batches,
                   "handoff": self.handoff,
                   "n_handoff_tiles": self.n_handoff_tiles,
                   "n_fallback_queries": self.n_fallback_queries,
                   "graph_tiles": self.graph_tiles,
                   "eager_tiles": self.eager_tiles,
                   "jobs_bucket": self.jobs_bucket,
                   "rung_tiles": {f"{w}x{n}": c for (w, n), c
                                  in sorted(self.rung_tiles.items())},
                   "stage_s": {k: round(v, 3)
                               for k, v in self.stage_s.items()}}
        if lat.size:
            out["encode_p50_ms"] = round(
                float(np.percentile(lat, 50)) * 1e3, 2)
        return out
