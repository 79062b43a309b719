"""Resident retrieval serving: request queue → micro-batched device tiles
(port of serving/server.py: ``SparseTileBackend``, ``DenseTileBackend``,
``RetrievalServer``, the stdlib HTTP facade ``serve_http`` and the CLI).

    python -m scaling_retriever_tpu_torch.serving.server --index_dir IDX
    python -m scaling_retriever_tpu_torch.serving.server --dense_index_dir D

Raw-text queries (``--model_name_or_path``) wait for checkpoint and
tokenizer loading (ROADMAP A7) and raise.

The server owns a warmed engine, accepts concurrent single-query requests,
coalesces them into tiles of a fixed width ladder, and overlaps tile
dispatch with result drain:

* **Fixed tile shapes.** Every micro-batch is padded to a width rung and
  the engine picks its job bucket from the batch's need; ``warmup()`` runs
  the shapes a sample of real traffic exercises before serving.
* **Dispatch ahead under load.** While a tile runs on the device, the
  previous tile's results are read and resolved; an idle server resolves
  at once. A two-pass engine (the block-max engine) has the previous
  tile advanced to its second pass (``advance``) right after the next
  tile's first pass is dispatched, so the second pass overlaps it.
* **Micro-batching window.** A request waits at most ``max_wait_ms`` for
  co-riders.
* **Cost-aware admission.** On a power-law index per-query job need varies
  by orders of magnitude and one expensive co-rider inflates the whole
  tile's sort slab, so tiles form cost-homogeneously (``_collect``).
* **Slow lane for hot queries.** A query whose job need exceeds
  ``max_need_jobs`` goes to ``hot_lane`` (a host engine) when one is
  configured and is rejected otherwise.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from scaling_retriever_tpu_torch.ops.segsort_scoring import bucket_jobs

LATENCY_WINDOW = 65536


class SparseTileBackend:
    """Adapts a segsort-protocol engine (``retrieve_tile_async`` /
    ``finalize``) to the server's dispatch/drain interface. ``widths`` is
    the tile width ladder (a micro-batch rides the smallest rung that holds
    it); ``t_budget`` the query-term width (requests with more nonzeros
    widen it for good, counted in ``widenings``)."""

    def __init__(self, engine, doc_ids: Optional[Sequence], n_docs: int,
                 width: int = 64, t_budget: int = 64, topk: int = 1000,
                 widths: Optional[Sequence[int]] = None,
                 max_need_jobs: int = 8192, hot_lane=None,
                 tile_slots_cap: Optional[int] = 32768):
        self.engine = engine
        # slow lane for over-budget queries: an object with
        # ``retrieve_sparse(terms, vals, topk) -> (rows, scores)``; None =
        # such queries are rejected at submit time
        self.hot_lane = hot_lane
        # None = identity mapping (row ids ARE the doc ids)
        self.doc_ids = (None if doc_ids is None
                        else np.asarray(doc_ids, dtype=object))
        self.n_docs = n_docs
        self.widths = tuple(sorted(widths)) if widths else (width,)
        self.width = self.widths[-1]
        self.t_budget = t_budget
        self.topk = topk
        self.max_need_jobs = max_need_jobs
        # co-riders are admitted only while width_rung * job_bucket(max
        # need) stays <= tile_slots_cap (the 64 x 512 standard tile); a
        # lone request always dispatches. None disables the cap.
        self.tile_slots_cap = tile_slots_cap
        self.widenings = 0

    def request_cost(self, query) -> int:
        """Per-query DMA job need (the engines' cost unit); 0 when the
        engine has no cost model (then the cap never splits)."""
        if getattr(self.engine, "job_need", None) is None:
            return 0
        terms, vals = query
        return int(self.engine.job_need(
            np.asarray(terms, np.int32)[None, :],
            np.asarray(vals, np.float32)[None, :]).max())

    def admit(self, batch_costs: list, next_cost: int) -> bool:
        """Would adding a request of ``next_cost`` keep the padded tile
        inside the slot envelope?"""
        if self.tile_slots_cap is None:
            return True
        new_max = max(max(batch_costs), next_cost)
        if new_max <= 0:
            return True
        n = len(batch_costs) + 1
        rung = next((w for w in self.widths if w >= n), self.width)
        return rung * bucket_jobs(new_max) <= self.tile_slots_cap

    def route(self, query) -> str:
        """Pick a lane for the request (on the client thread, so only the
        offending request errors): "fast", "hot", or raise when the need
        exceeds ``max_need_jobs`` and no hot lane is configured."""
        need = self.request_cost(query)
        if need <= self.max_need_jobs:
            return "fast"
        if self.hot_lane is not None:
            return "hot"
        raise ValueError(
            f"query needs {need} DMA jobs > serving cap "
            f"{self.max_need_jobs} (~{self.max_need_jobs * 1024 / 1e6:.0f}M "
            f"matched postings); configure a hot_lane")

    def search_hot(self, query, topk: int):
        """Slow-lane scoring on the host engine; same result format."""
        terms, vals = query
        rows, scores = self.hot_lane.retrieve_sparse(
            np.asarray(terms, np.int32), np.asarray(vals, np.float32),
            self.topk)
        valid = (rows >= 0) & (rows < self.n_docs) & np.isfinite(scores)
        kept = rows[valid]
        ids = (kept.tolist() if self.doc_ids is None
               else self.doc_ids[kept].tolist())
        return ids[:topk], scores[valid][:topk].astype(float).tolist()

    def pack(self, reqs: list) -> tuple[np.ndarray, np.ndarray]:
        """[(terms, vals), ...] → (q_terms, q_vals) padded to the smallest
        width rung that holds the batch."""
        mx = max((len(r[0]) for r in reqs), default=0)
        if mx > self.t_budget:
            self.t_budget = -(-mx // 8) * 8
            self.widenings += 1
        width = next(w for w in self.widths if w >= len(reqs))
        qt = np.zeros((width, self.t_budget), np.int32)
        qv = np.zeros((width, self.t_budget), np.float32)
        for i, (terms, vals) in enumerate(reqs):
            qt[i, :len(terms)] = terms
            qv[i, :len(vals)] = vals
        return qt, qv

    def dispatch(self, reqs: list):
        qt, qv = self.pack(reqs)
        return self.engine.retrieve_tile_async(None, self.topk,
                                               sparsified=(qt, qv))

    def advance(self, payload):
        """Advance a two-pass engine's payload to its second stage (read
        pass 1, dispatch pass 2: ``BlockMaxSegsortEngine.continue_async``)
        so pass 2 overlaps the next tile's pass 1 instead of running
        inside ``drain``. Idempotent; a no-op for single-pass engines."""
        fn = getattr(self.engine, "continue_async", None)
        return fn(payload) if fn is not None else payload

    def drain(self, payload, reqs: list) -> list:
        scores, rows = self.engine.finalize(payload)
        return self._to_results(scores, rows, len(reqs))

    def _to_results(self, scores, rows, n_real: int) -> list:
        out = []
        for i in range(n_real):
            valid = ((rows[i] >= 0) & (rows[i] < self.n_docs)
                     & np.isfinite(scores[i]))
            kept = rows[i][valid]
            ids = (kept.tolist() if self.doc_ids is None
                   else self.doc_ids[kept].tolist())
            out.append((ids, scores[i][valid].astype(float).tolist()))
        return out


class DenseTileBackend:
    """Adapts a ``DenseFlatIndexer`` (or any ``search_knn``-style object).
    Each micro-batch is padded to the smallest rung of the width ladder
    with COPIES of its first query, never zeros: a zero row fails the
    block-selection certificate (tau = max_bm = 0) and would send every
    ragged tile through the exact rerun. Pad rows are sliced off in
    ``drain``."""

    def __init__(self, indexer, width: int = 64, topk: int = 1000,
                 widths: Optional[Sequence[int]] = None):
        self.indexer = indexer
        self.widths = tuple(sorted(widths)) if widths else (8, width)
        self.width = self.widths[-1]
        self.topk = topk
        self.t_budget = None

    def pack(self, reqs: list) -> np.ndarray:
        q = np.stack([np.asarray(r, np.float32) for r in reqs])
        rung = next((w for w in self.widths if w >= len(reqs)), self.width)
        if rung > len(reqs):
            q = np.concatenate(
                [q, np.broadcast_to(q[0], (rung - len(reqs), q.shape[1]))])
        return q

    def dispatch(self, reqs: list):
        """Asynchronous dispatch (``DenseFlatIndexer.dispatch_tile``, no
        host read), so the broker overlaps tile i+1's products with tile
        i's drain; an object with only ``search_knn`` runs in drain."""
        disp = getattr(self.indexer, "dispatch_tile", None)
        if disp is None:
            return ("sync", self.pack(reqs))
        k = min(self.topk, getattr(self.indexer, "ntotal", self.topk))
        return ("async", disp(self.pack(reqs), k))

    def drain(self, payload, reqs: list) -> list:
        kind, data = payload
        if kind == "async":
            scores, rows = self.indexer.drain_tile(data, len(reqs))
            hits = self.indexer.tile_results(scores, rows, len(reqs))
        else:
            hits = self.indexer.search_knn(data, self.topk)[:len(reqs)]
        return [(ids, list(map(float, sc))) for ids, sc in hits]


_STOP = object()


class ServerOverloadedError(RuntimeError):
    """A lane's bounded queue is full and the caller asked not to wait
    (``submit(timeout=...)`` elapsed, or the hot lane's in-flight cap is
    reached). The HTTP facade maps this to 429."""


class RetrievalServer:
    """Micro-batching request broker over a tile backend.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to
    ``(doc_ids, scores)``; ``search`` is the blocking wrapper. One worker
    thread owns the device: it collects up to ``backend.width`` requests
    per tile, waiting at most ``max_wait_ms`` after the first, dispatches,
    and under load drains tile i while tile i+1 runs.
    """

    def __init__(self, backend, max_wait_ms: float = 2.0,
                 queue_limit: int = 4096, pipeline_depth: int = 2,
                 max_pipeline_depth: int = 3, hot_queue_limit: int = 32,
                 hot_workers: int = 1, reorder_horizon: int = 4,
                 max_collect_ms: Optional[float] = None):
        self.backend = backend
        self.max_wait = max_wait_ms / 1e3
        # burst collection (None = off): each arrival extends the collect
        # deadline by one max_wait_ms quiet gap, capped at max_collect_ms
        self.max_collect = (None if max_collect_ms is None
                            else max_collect_ms / 1e3)
        # cost-modeled backends: _collect's candidate pool is
        # reorder_horizon * width, so admission sorts a wider window into
        # purer cost classes (latency-bound deployments set 1)
        self.reorder_horizon = max(1, reorder_horizon)
        # tiles in flight ahead of the oldest drain. With closed-loop
        # clients a deeper pipeline drains the queue faster and batches
        # form smaller, so the base depth is 2; when the queue already
        # holds a full tile, depth may grow to max_pipeline_depth
        self.pipeline_depth = max(1, pipeline_depth)
        self.max_pipeline_depth = max(self.pipeline_depth,
                                      max_pipeline_depth)
        self._q: queue.Queue = queue.Queue(maxsize=queue_limit)
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # host slow lane: its own bounded worker pool, so a pathological
        # query never occupies the device worker
        self._hot_pool = None
        self._hot_workers = max(1, hot_workers)
        self.hot_queue_limit = hot_queue_limit
        self._hot_inflight = 0
        self.n_requests = 0
        self.n_hot = 0
        self.n_hot_shed = 0
        self.n_fast_shed = 0
        # requests cost-rejected from a forming tile (see _collect)
        self.n_cost_splits = 0
        # requests pulled from the queue but cost-rejected from the forming
        # tile, in arrival order; they are candidates of the next collect
        # (and head the next tile), never dropped
        self._stash: list = []
        self.n_batches = 0
        # the most recent tiles' sizes and the two lanes' latencies
        self.batch_sizes = collections.deque(maxlen=LATENCY_WINDOW)
        self.latencies_s = collections.deque(maxlen=LATENCY_WINDOW)
        self.hot_latencies_s = collections.deque(maxlen=LATENCY_WINDOW)
        # wall-clock split of the worker loop: "wait" = queue idle,
        # "collect" = batch formation, "dispatch" = pack + engine dispatch,
        # "drain" = read + result conversion + future resolution
        self.stage_s = {"wait": 0.0, "collect": 0.0, "dispatch": 0.0,
                        "drain": 0.0}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "RetrievalServer":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        if getattr(self.backend, "hot_lane", None) is not None:
            self._hot_pool = ThreadPoolExecutor(
                max_workers=self._hot_workers, thread_name_prefix="srt-hot")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._started:
            self._q.put(_STOP)
            self._thread.join()
            if self._hot_pool is not None:
                self._hot_pool.shutdown(wait=True)
                self._hot_pool = None
            self._started = False
            for item in self._stash:
                item[2].set_exception(
                    RuntimeError("server stopped before request ran"))
            self._stash = []
            # a submit racing stop() can land behind the sentinel
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _STOP:
                    item[2].set_exception(
                        RuntimeError("server stopped before request ran"))

    def __enter__(self) -> "RetrievalServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API ----------------------------------------------------

    def submit(self, query, topk: Optional[int] = None,
               timeout: Optional[float] = None) -> Future:
        """query: (terms, vals) for sparse backends, a vector for dense
        ones. topk above the backend's k is rejected;
        a smaller topk is a slice of the result. Raises on a server not
        started and on requests the backend rejects, so only the offending
        caller errors. ``timeout`` bounds how long submit may block for
        queue space (None = wait; a number sheds with
        ServerOverloadedError; 0 = never block)."""
        if not self._started:
            raise RuntimeError("server not started — a submit would hang")
        k = self.backend.topk
        if topk is not None and topk > k:
            raise ValueError(f"topk {topk} > backend topk {k}")
        route = getattr(self.backend, "route", None)
        lane = route(query) if route is not None else "fast"
        fut: Future = Future()
        if lane == "hot":
            with self._lock:
                if self._hot_inflight >= self.hot_queue_limit:
                    self.n_hot_shed += 1
                    raise ServerOverloadedError(
                        f"hot lane at capacity ({self._hot_inflight} "
                        f"queries in flight, limit {self.hot_queue_limit})")
                self._hot_inflight += 1
                self.n_requests += 1
                self.n_hot += 1
            self._submit_hot(query, topk or k, fut)
            return fut
        item = (query, topk or k, fut, time.perf_counter())
        try:
            if timeout is None:
                self._q.put(item)
            else:
                self._q.put(item, block=timeout > 0, timeout=timeout or None)
        except queue.Full:
            with self._lock:
                self.n_fast_shed += 1
            raise ServerOverloadedError(
                f"request queue full ({self._q.maxsize}) and did not drain "
                f"within {timeout}s") from None
        with self._lock:
            self.n_requests += 1
        return fut

    def _submit_hot(self, query, topk: int, fut: Future) -> None:
        t_sub = time.perf_counter()

        def run():
            try:
                res = self.backend.search_hot(query, topk)
            except Exception as e:
                fut.set_exception(e)
                return
            finally:
                with self._lock:
                    self._hot_inflight -= 1
            with self._lock:
                self.hot_latencies_s.append(time.perf_counter() - t_sub)
            fut.set_result(res)

        self._hot_pool.submit(run)

    def search(self, query, topk: Optional[int] = None):
        return self.submit(query, topk).result()

    # -- warm pool -----------------------------------------------------

    def warmup(self, sample_queries: list, passes: int = 3) -> dict:
        """Run every width rung, filled from ``sample_queries``, and the
        sample itself in full tiles, ``passes`` times each, before serving
        (the first runs of a shape pay allocator growth and library
        autotuning). Call before ``start()``."""
        if self._started:
            raise RuntimeError("warm up before start() — the worker owns "
                               "the device")
        t0 = time.perf_counter()
        width = self.backend.width
        n = 0
        for w in getattr(self.backend, "widths", (width,)):
            if not sample_queries:
                continue
            # fill the rung: a short sample would warm a smaller rung
            reps = -(-w // len(sample_queries))
            reqs = (list(sample_queries) * reps)[:w]
            for _ in range(passes):
                self.backend.drain(self.backend.dispatch(reqs), reqs)
                n += 1
        for s in range(width, len(sample_queries), width):
            reqs = sample_queries[s:s + width]
            for _ in range(passes):
                self.backend.drain(self.backend.dispatch(reqs), reqs)
                n += 1
        return {"warmup_s": round(time.perf_counter() - t0, 3),
                "warmup_tiles": n}

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self.latencies_s, np.float64)
            hot_lat = np.asarray(self.hot_latencies_s, np.float64)
            sizes = list(self.batch_sizes)
            hot_inflight = self._hot_inflight
        out = {"n_requests": self.n_requests, "n_batches": self.n_batches,
               "n_hot": self.n_hot, "n_hot_shed": self.n_hot_shed,
               "n_fast_shed": self.n_fast_shed,
               "n_cost_splits": self.n_cost_splits,
               "hot_inflight": hot_inflight,
               "mean_batch": round(float(np.mean(sizes)), 2) if sizes else 0.0,
               "t_budget": self.backend.t_budget,
               "widenings": getattr(self.backend, "widenings", 0),
               "stage_s": {k: round(v, 3) for k, v in self.stage_s.items()}}
        engine_stats = getattr(getattr(self.backend, "engine", None),
                               "stats", None)
        if engine_stats is not None:
            out["engine"] = engine_stats()
        if lat.size:
            out.update({
                "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
                "latency_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 2),
                "latency_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
                "latency_max_ms": round(float(lat.max()) * 1e3, 2),
            })
        if hot_lat.size:
            out.update({
                "hot_latency_p50_ms": round(
                    float(np.percentile(hot_lat, 50)) * 1e3, 2),
                "hot_latency_max_ms": round(float(hot_lat.max()) * 1e3, 2),
            })
        return out

    # -- worker --------------------------------------------------------

    def _collect(self, first) -> list:
        """One micro-batch: ``first`` plus co-riders arriving within the
        window, capped at the tile width and, for cost-modeled backends, at
        the tile slot envelope (``backend.admit``). The head request is
        always kept. Co-riders at or under the head's job bucket ride its
        already-paid slab, most expensive first, so an expensive head's
        tile retires the pool's expensive class in one slab; riders above
        the head's bucket sort last, cheapest first. Rejected candidates
        are stashed in arrival order and are candidates again at the next
        collect; they are never dropped."""
        batch = [first]
        use_cost = (getattr(self.backend, "admit", None) is not None
                    and getattr(self.backend, "tile_slots_cap", None))
        start = time.perf_counter()
        deadline = start + self.max_wait
        hard = start + self.max_collect if self.max_collect else None
        # previously deferred requests ride as candidates first
        riders = self._stash
        self._stash = []
        saw_stop = False
        # with a cost model the candidate pool extends past one tile width
        pool_cap = (self.backend.width * self.reorder_horizon if use_cost
                    else self.backend.width)
        while len(batch) + len(riders) < pool_cap:
            remaining = deadline - time.perf_counter()
            try:
                item = self._q.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            if item is _STOP:
                saw_stop = True
                break
            riders.append(item)
            if hard is not None:
                deadline = min(time.perf_counter() + self.max_wait, hard)
        if use_cost and riders:
            head_cost = self._cost(first)
            costs = [head_cost]
            rider_cost = [self._cost(r) for r in riders]
            head_bucket = bucket_jobs(head_cost)
            order = sorted(
                range(len(riders)),
                key=lambda i: ((0, -rider_cost[i])
                               if bucket_jobs(rider_cost[i]) <= head_bucket
                               else (1, rider_cost[i])))
            rejected = set()
            for i in order:
                if (len(costs) < self.backend.width
                        and self.backend.admit(costs, rider_cost[i])):
                    costs.append(rider_cost[i])
                else:
                    rejected.add(i)
            if rejected:
                self._stash.extend(riders[i] for i in sorted(rejected))
                with self._lock:
                    self.n_cost_splits += len(rejected)
                riders = [riders[i] for i in range(len(riders))
                          if i not in rejected]
        batch += riders
        if saw_stop:
            batch.append(_STOP)
        return batch

    def _cost(self, item) -> int:
        """Per-request job cost, cached on the request's Future (stashed
        requests are considered again at every collect)."""
        c = getattr(item[2], "_srt_cost", None)
        if c is None:
            c = self.backend.request_cost(item[0])
            item[2]._srt_cost = c
        return c

    def _resolve(self, pending) -> None:
        reqs, payload = pending
        t0 = time.perf_counter()
        try:
            results = self.backend.drain(payload, [r[0] for r in reqs])
        except Exception as e:  # fail every waiter of this tile, keep serving
            for _, _, fut, _ in reqs:
                if not fut.done():
                    fut.set_exception(e)
            return
        now = time.perf_counter()
        with self._lock:
            self.n_batches += 1
            self.batch_sizes.append(len(reqs))
            for (_, topk, fut, t_sub), (ids, sc) in zip(reqs, results):
                self.latencies_s.append(now - t_sub)
                fut.set_result((ids[:topk], sc[:topk]))
        self.stage_s["drain"] += time.perf_counter() - t0

    def _loop(self) -> None:
        pending: list = []
        stop = False
        while not stop:
            if self._stash:
                first = self._stash.pop(0)   # a deferred request heads
            else:
                try:
                    # with tiles in flight, poll so they resolve as soon as
                    # traffic pauses; idle, block until traffic arrives
                    t0 = time.perf_counter()
                    first = self._q.get(block=not pending, timeout=None)
                    self.stage_s["wait"] += time.perf_counter() - t0
                except queue.Empty:
                    first = None
            if first is _STOP:
                stop = True
            elif first is not None:
                t0 = time.perf_counter()
                batch = self._collect(first)
                self.stage_s["collect"] += time.perf_counter() - t0
                if batch and batch[-1] is _STOP:
                    stop = True
                    batch = batch[:-1]
                if stop and self._stash:
                    # serve the deferred requests first, then honor the
                    # re-queued stop
                    self._q.put(_STOP)
                    stop = False
                if batch:
                    t0 = time.perf_counter()
                    try:
                        payload = self.backend.dispatch(
                            [r[0] for r in batch])
                    except Exception as e:
                        # a bad request fails ITS batch, never the worker
                        for _, _, fut, _ in batch:
                            if not fut.done():
                                fut.set_exception(e)
                        continue
                    self.stage_s["dispatch"] += time.perf_counter() - t0
                    pending.append((batch, payload))
                    # two-pass engines: advance the previous tile to its
                    # second pass while this tile's first pass runs. Like
                    # dispatch and drain, a failure fails its own batch
                    # and never the worker
                    adv = getattr(self.backend, "advance", None)
                    if adv is not None and len(pending) >= 2:
                        prev_batch, prev_payload = pending[-2]
                        try:
                            pending[-2] = (prev_batch, adv(prev_payload))
                        except Exception as e:
                            for _, _, fut, _ in prev_batch:
                                if not fut.done():
                                    fut.set_exception(e)
                            del pending[-2]
                    depth = (self.max_pipeline_depth
                             if (self._q.qsize() + len(self._stash)
                                 >= self.backend.width)
                             else self.pipeline_depth)
                    if len(pending) >= depth:
                        self._resolve(pending.pop(0))
                    continue
            if pending:
                self._resolve(pending.pop(0))
        for p in pending:
            self._resolve(p)


# ---------------------------------------------------------------------------
# stdlib HTTP front-end


def serve_http(server: RetrievalServer, host: str = "127.0.0.1",
               port: int = 8080, block: bool = True, frontend=None,
               submit_timeout_s: Optional[float] = 5.0):
    """JSON-over-HTTP facade. POST /search body:
    ``{"queries": [{"id": "q1", "terms": [...], "vals": [...]}, ...],
       "topk": 10}``
    (dense backends: ``{"id": ..., "vector": [...]}``; with a
    ``frontend``, a started QueryEncoderFrontend, raw-text queries
    ``{"id": ..., "text": "..."}`` are encoded first) →
    ``{"results": {"q1": {"d3": 12.5, ...}}}``, the run.json entry shape.
    GET /stats and GET /healthz for operators.

    ``submit_timeout_s`` bounds how long a request may wait for queue space
    before the facade sheds it as HTTP 429 (hot-lane capacity sheds 429 at
    once); None waits without bound. ``block=False`` returns the server
    unstarted (``serve_forever`` on a thread of the caller's)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/stats":
                stats = server.stats()
                if frontend is not None:
                    stats["encode"] = frontend.stats()
                self._send(200, stats)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/search":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                topk = req.get("topk")
                futs = []
                for q in req["queries"]:
                    if "text" in q:
                        if frontend is None:
                            raise ValueError("text queries need an encoder "
                                             "frontend (none configured)")
                        fut = frontend.submit_text(q["text"], topk)
                    elif "vector" in q:
                        fut = server.submit(
                            np.asarray(q["vector"], np.float32), topk,
                            timeout=submit_timeout_s)
                    else:
                        fut = server.submit(
                            (np.asarray(q["terms"], np.int32),
                             np.asarray(q["vals"], np.float32)), topk,
                            timeout=submit_timeout_s)
                    futs.append((str(q.get("id", len(futs))), fut))
                results = {}
                for qid, f in futs:
                    ids, scores = f.result()
                    results[qid] = dict(zip(map(str, ids), scores))
                self._send(200, {"results": results})
            except ServerOverloadedError as e:
                # load balancers retry or shed on 429; a submit blocked
                # forever would hold the connection and hide the overload
                self._send(429, {"error": f"overloaded: {e}",
                                 "retry_after_s": 1})
            except Exception as e:  # a bad request answers 400, serving goes on
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    return httpd


# ---------------------------------------------------------------------------
# CLI: python -m scaling_retriever_tpu_torch.serving.server --index_dir ...


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description="resident retrieval server")
    ap.add_argument("--index_dir", default=None,
                    help="sparse inverted-index directory")
    ap.add_argument("--dense_index_dir", default=None,
                    help="serialized DenseFlatIndexer directory "
                         "(index_srt.npz): serves dense vector queries")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--topk", type=int, default=1000)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--widths", default=None,
                    help="comma-separated width ladder (e.g. 8,64): "
                         "isolated requests ride the narrow rung")
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--max_collect_ms", type=float, default=None,
                    help="burst-collection cap: each arrival extends the "
                         "collect window by one max_wait_ms quiet gap up "
                         "to this total. Unset = one fixed window")
    ap.add_argument("--pipeline_depth", type=int, default=2,
                    help="tiles dispatched ahead of the oldest drain")
    ap.add_argument("--reorder_horizon", type=int, default=4,
                    help="cost-scheduler candidate pool = horizon x width; "
                         "1 for strict latency limits")
    ap.add_argument("--hot_lane", choices=("none", "cpp"), default="cpp",
                    help="slow lane for over-budget queries: 'cpp' scores "
                         "them on the host C++ engine over the same CSR; "
                         "'none' rejects them")
    ap.add_argument("--max_need_jobs", type=int, default=8192,
                    help="job budget above which a query leaves the device "
                         "lane (~1024 matched postings per job)")
    ap.add_argument("--warmup_queries", default=None,
                    help="npz with q_terms/q_vals (sparse) or reps (dense) "
                         "arrays, run through every width rung before "
                         "serving")
    ap.add_argument("--model_name_or_path", default=None,
                    help="sparse encoder checkpoint dir: enables raw-text "
                         "queries ({'text': ...}) through a micro-batched "
                         "encode stage on the device (text_frontend.py); "
                         "its tokenizer is loaded by transformers")
    ap.add_argument("--lora_name_or_path", default=None)
    ap.add_argument("--query_max_length", type=int, default=64)
    ap.add_argument("--query_length_rungs", default="auto",
                    help="comma list of token-length rungs (a batch pads "
                         "to the smallest rung covering it); 'auto' = "
                         "powers of two from 16 below query_max_length; "
                         "'none' = one fixed length")
    ap.add_argument("--t_sparse", type=int, default=64,
                    help="top-T sparsification width of encoded queries")
    ap.add_argument("--encode_widths", default="8,64",
                    help="encoder tile width ladder")
    ap.add_argument("--warmup_texts", default=None,
                    help="text file (one query per line) run through the "
                         "encoder width rungs before serving")
    ap.add_argument("--handoff", choices=("auto", "off"), default="auto",
                    help="device encode->retrieve handoff for text "
                         "queries: the sparsified reps stay on the device "
                         "and feed the retrieval directly ('auto': when "
                         "the engine fetches by DMA over f32 or q8)")
    ap.add_argument("--dense_quantize", choices=("none", "int8"),
                    default="none",
                    help="dense layout: int8 = per-doc symmetric codes + "
                         "f32 scales (1 B/dim, exact over the codes); the "
                         "on-disk index stays f32")
    ap.add_argument("--val_dtype", choices=("f32", "bf16", "q8"),
                    default="f32",
                    help="sparse posting layout: f32 (8 B), bf16 pairs "
                         "(6 B) or q8 (row24|code8) words (4 B)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index and engine (cuda, "
                         "cuda:N or cpu)")
    return ap


def main(argv=None) -> None:
    import sys

    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.index_dir is None) == (args.dense_index_dir is None):
        ap.error("exactly one of --index_dir / --dense_index_dir is required")
    if args.model_name_or_path and args.dense_index_dir:
        ap.error("--model_name_or_path pairs with the sparse backend "
                 "(--index_dir)")

    t0 = time.perf_counter()
    widths = ([int(w) for w in args.widths.split(",")]
              if args.widths else None)
    if args.index_dir:
        from scaling_retriever_tpu_torch.index.inverted_index import \
            SparseIndex
        from scaling_retriever_tpu_torch.ops.segsort_scoring import \
            SegsortEngine

        index = SparseIndex.load(args.index_dir)
        engine = SegsortEngine(index, topk=args.topk,
                               val_dtype=args.val_dtype, device=args.device)
        hot_lane = None
        if args.hot_lane == "cpp":
            from scaling_retriever_tpu_torch.index.cpp_engine import \
                CppSparseEngine

            # shares the host CSR the index was loaded into
            hot_lane = CppSparseEngine(index, n_threads=1)
        backend = SparseTileBackend(engine, index.doc_ids, index.nb_docs(),
                                    width=args.width, widths=widths,
                                    topk=args.topk, hot_lane=hot_lane,
                                    max_need_jobs=args.max_need_jobs)
    else:
        from scaling_retriever_tpu_torch.index.dense_index import \
            DenseFlatIndexer

        indexer = DenseFlatIndexer(
            quantize=None if args.dense_quantize == "none"
            else args.dense_quantize, device=args.device)
        indexer.deserialize(args.dense_index_dir)
        backend = DenseTileBackend(indexer, width=args.width,
                                   topk=args.topk, widths=widths)
    server = RetrievalServer(backend, max_wait_ms=args.max_wait_ms,
                             reorder_horizon=args.reorder_horizon,
                             pipeline_depth=args.pipeline_depth,
                             max_collect_ms=args.max_collect_ms)
    print(f"index + engine resident in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    frontend = None
    if args.model_name_or_path:
        frontend = _text_frontend(args, server, engine)
        print(f"encoder frontend resident ({args.model_name_or_path})",
              file=sys.stderr)
    if args.warmup_queries:
        z = np.load(args.warmup_queries)
        if "reps" in z:
            qs = list(z["reps"])
        else:
            qs = [(z["q_terms"][i], z["q_vals"][i])
                  for i in range(len(z["q_terms"]))]
        print(f"warmup: {server.warmup(qs)}", file=sys.stderr)
    if frontend is not None and args.warmup_texts:
        with open(args.warmup_texts) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
        print(f"encoder warmup: {frontend.warmup(texts)}", file=sys.stderr)
    server.start()
    if frontend is not None:
        frontend.start()
    try:
        # bound before the line is printed: with --port 0 the line names
        # the port the system picked
        httpd = serve_http(server, args.host, args.port, block=False,
                           frontend=frontend)
        print(f"serving on http://{args.host}:{httpd.server_address[1]}",
              file=sys.stderr, flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        if frontend is not None:
            frontend.stop()
        server.stop()


def _text_frontend(args, server, engine):
    """The QueryEncoderFrontend of ``--model_name_or_path``: the encoder on
    ``--device``, the handoff encode fn where the engine takes it."""
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, load_sparse_encoder, make_encode_fn,
        make_encode_fn_handoff, make_hf_tokenize_fn)

    model, tokenizer = load_sparse_encoder(
        args.model_name_or_path, args.lora_name_or_path, device=args.device)
    if args.query_length_rungs == "none":
        rungs = None
    elif args.query_length_rungs == "auto":
        rungs, r = [], 16
        while r < args.query_max_length:
            rungs.append(r)
            r *= 2
    else:
        rungs = [int(x) for x in args.query_length_rungs.split(",")]
    use_handoff = (args.handoff == "auto"
                   and getattr(engine, "fetch", None) == "dma"
                   and getattr(engine, "val_dtype", "f32") in ("f32", "q8"))
    encode_fn = (make_encode_fn_handoff(model, args.t_sparse) if use_handoff
                 else make_encode_fn(model, args.t_sparse))
    return QueryEncoderFrontend(
        server, encode_fn,
        make_hf_tokenize_fn(tokenizer, args.query_max_length, lengths=rungs),
        widths=[int(w) for w in args.encode_widths.split(",")],
        t_sparse=args.t_sparse, max_wait_ms=args.max_wait_ms)


if __name__ == "__main__":
    main()
