"""The serving layer's cost-aware admission and hot lane, through both
packages on the same index and queries: the JAX package's scenarios of
tests/test_serving.py (the hot lane routes, a mixed stream, a flood shed
while the fast lane holds, a cost-aware split, the expensive class grouped
by bucket), each run on ``scaling_retriever_tpu`` and on the port with the
same invariants and the same results, plus both packages' ``_collect`` fed
one pre-filled queue of costed requests, whose batches must be equal. The
hot lane is an exact numpy scorer over the index (the JAX scenarios' C++
engine builds in place, which the port's tests leave alone)."""

import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import scaling_retriever_tpu.index.inverted_index as jax_index
import scaling_retriever_tpu.ops.segsort_scoring as jax_segsort
import scaling_retriever_tpu.serving.server as jax_server
import scaling_retriever_tpu_torch.index.inverted_index as torch_index
import scaling_retriever_tpu_torch.ops.segsort_scoring as torch_segsort
import scaling_retriever_tpu_torch.serving.server as torch_server

torch.set_num_threads(1)

V = 96
N_DOCS = 60
PKGS = {
    "jax": types.SimpleNamespace(
        index=jax_index, server=jax_server,
        engine=lambda idx, **kw: jax_segsort.SegsortEngine(idx, **kw)),
    "torch": types.SimpleNamespace(
        index=torch_index, server=torch_server,
        engine=lambda idx, **kw: torch_segsort.SegsortEngine(
            idx, device="cpu", **kw)),
}


def _triples(seed: int = 7):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for d in range(N_DOCS):
        nnz = rng.integers(3, 9)
        terms = rng.choice(V, size=nnz, replace=False)
        rows.extend([d] * nnz)
        cols.extend(terms.tolist())
        vals.extend(rng.uniform(0.1, 3.0, size=nnz).tolist())
    return (np.array(rows), np.array(cols), np.array(vals, np.float32),
            [f"d{d}" for d in range(N_DOCS)], V)


TRIPLES = _triples()


def _queries(n, seed, t=6):
    rng = np.random.default_rng(seed)
    return [(rng.choice(V, size=t, replace=False).astype(np.int32),
             rng.uniform(0.2, 2.0, size=t).astype(np.float32))
            for _ in range(n)]


def _with_parity(qs, odd):
    """Queries whose first term's parity is odd where ``odd(i)`` (the cost
    marker of the costed backends), terms kept distinct."""
    out = []
    for i, (terms, vals) in enumerate(qs):
        terms = terms.copy()
        terms[0] = (int(terms[0]) // 2) * 2 + int(odd(i))
        while terms[0] in terms[1:]:
            terms[0] = (terms[0] + 2) % V
        out.append((terms, vals))
    return out


class NumpyHotLane:
    """Exact host scoring over the index (the hot lane's contract)."""

    def __init__(self, idx, delay_s: float = 0.0):
        self.idx = idx
        self.delay_s = delay_s

    def retrieve_sparse(self, terms, vals, topk):
        time.sleep(self.delay_s)
        scores = np.zeros(N_DOCS, np.float32)
        for t, v in zip(terms, vals):
            r, w = self.idx.posting(int(t))
            scores[r] += np.float32(v) * w
        order = np.argsort(-scores, kind="stable")[:topk]
        order = order[scores[order] > 0]
        return order.astype(np.int64), scores[order]


def _oracle(terms, vals, k=10):
    rows, cols, vv, _, _ = TRIPLES
    dense = np.zeros(V, np.float32)
    dense[terms] = vals
    scores = np.zeros(N_DOCS, np.float32)
    np.add.at(scores, rows, dense[cols] * vv)
    order = np.argsort(-scores, kind="stable")[:k]
    return {f"d{d}": scores[d] for d in order if scores[d] > 0}


def _exact(result, terms, vals):
    ids, scores = result
    want = _oracle(terms, vals)
    got = dict(zip(ids, scores))
    assert set(got) == set(want)
    for d, s in want.items():
        np.testing.assert_allclose(got[d], s, rtol=1e-5)
    assert list(scores) == sorted(scores, reverse=True)


def _setup(pkg, **backend_kw):
    idx = pkg.index.SparseIndex.from_triples(*TRIPLES)
    eng = pkg.engine(idx, topk=10, query_terms_budget=8, min_budget=256,
                     fetch="gather")
    cls = backend_kw.pop("cls", pkg.server.SparseTileBackend)
    backend = cls(eng, idx.doc_ids, idx.nb_docs(), t_budget=8, topk=10,
                  **backend_kw)
    return idx, eng, backend


def _rounded(result):
    ids, scores = result
    return list(ids), [round(float(s), 4) for s in scores]


# ---- the scenarios: each returns what must equal across packages -------


def hot_lane_routes(pkg):
    """Over-budget queries score on the host lane and never occupy the
    device worker."""
    idx, _, backend = _setup(pkg, width=4, max_need_jobs=0)
    backend.hot_lane = NumpyHotLane(idx)
    out = []
    with pkg.server.RetrievalServer(backend) as server:
        for terms, vals in _queries(5, 11):
            res = server.search((terms, vals))
            _exact(res, terms, vals)
            out.append(_rounded(res))
        st = server.stats()
    assert st["n_hot"] == 5 and st["n_batches"] == 0
    assert st["hot_latency_p50_ms"] > 0 and "latency_p50_ms" not in st
    return {"results": out, "n_hot": st["n_hot"]}


def hot_lane_mixed_stream(pkg):
    """Fast queries ride the device while a hot query in the same stream
    takes the host lane; both exact."""
    idx, eng, backend = _setup(pkg, width=4, max_need_jobs=20)
    backend.hot_lane = NumpyHotLane(idx)
    hot = (np.arange(40, dtype=np.int32), np.full(40, 0.5, np.float32))
    assert int(eng.job_need(hot[0][None], hot[1][None]).max()) > 20
    server = pkg.server.RetrievalServer(backend, max_wait_ms=2.0)
    server.warmup(_queries(4, 12), passes=1)
    fast = _queries(4, 13)
    with server:
        futs = [server.submit(q) for q in fast]
        hot_fut = server.submit(hot)
        out = []
        for (terms, vals), f in zip(fast, futs):
            res = f.result(timeout=60)
            _exact(res, terms, vals)
            out.append(_rounded(res))
        res = hot_fut.result(timeout=60)
        _exact(res, *hot)
        st = server.stats()
    assert st["n_hot"] == 1 and st["n_batches"] >= 1
    return {"results": out + [_rounded(res)], "n_hot": st["n_hot"]}


def hot_flood_is_shed(pkg):
    """A burst of slow hot queries queues up to ``hot_queue_limit`` and
    sheds the rest, while fast queries keep their latency."""
    idx, eng, backend = _setup(pkg, width=4, max_need_jobs=20)
    backend.hot_lane = NumpyHotLane(idx, delay_s=0.4)
    hot = (np.arange(40, dtype=np.int32), np.full(40, 0.5, np.float32))
    server = pkg.server.RetrievalServer(backend, max_wait_ms=2.0,
                                        hot_queue_limit=3)
    server.warmup(_queries(4, 14), passes=1)
    with server:
        hot_futs, shed = [], 0
        for _ in range(10):
            try:
                hot_futs.append(server.submit(hot))
            except pkg.server.ServerOverloadedError:
                shed += 1
        assert shed >= 7 and len(hot_futs) <= 3
        t0 = time.perf_counter()
        for terms, vals in _queries(6, 15):
            _exact(server.search((terms, vals)), terms, vals)
        assert time.perf_counter() - t0 < 1.0
        for f in hot_futs:
            _exact(f.result(timeout=60), *hot)
        st = server.stats()
    assert st["n_hot_shed"] == shed
    assert st["latency_p50_ms"] < st["hot_latency_p50_ms"]
    assert st["hot_inflight"] == 0
    return {"shed": shed, "admitted": len(hot_futs),
            "n_hot": st["n_hot"]}


def _costed(pkg, spy: bool = False):
    class Costed(pkg.server.SparseTileBackend):
        batch_costs = None

        def request_cost(self, query):
            # first term parity: even -> cheap (1), odd -> expensive (200)
            return 200 if int(query[0][0]) % 2 else 1

        def dispatch(self, requests):
            if self.batch_costs is not None:
                self.batch_costs.append(
                    [self.request_cost(q) for q in requests])
            return super().dispatch(requests)

    return Costed


def cost_aware_split(pkg):
    """A co-rider that would inflate the padded tile past the envelope is
    stashed and starts the next tile; nothing is dropped."""
    _, _, backend = _setup(pkg, cls=_costed(pkg), widths=(4, 8),
                           tile_slots_cap=512)
    assert backend.admit([1] * 7, 1)
    assert not backend.admit([1], 200) and not backend.admit([200], 1)
    server = pkg.server.RetrievalServer(backend, max_wait_ms=20.0)
    server.warmup(_queries(8, 16), passes=1)
    qs = _with_parity(_queries(6, 17), lambda i: i % 2)
    with server:
        futs = [server.submit(q) for q in qs]
        results = [f.result(timeout=60) for f in futs]
        for (terms, vals), res in zip(qs, results):
            _exact(res, terms, vals)
        assert server.n_cost_splits >= 1, server.stats()
        assert sum(server.batch_sizes) == len(qs)
    return {"results": [_rounded(r) for r in results]}


def expensive_class_grouped(pkg):
    """Behind an expensive head, riders at or under its bucket join most
    expensive first: two expensive requests four positions apart ride the
    same tile."""
    _, _, backend = _setup(pkg, cls=_costed(pkg), widths=(4, 8),
                           tile_slots_cap=1024)
    assert backend.admit([200, 200, 200], 200)
    assert not backend.admit([200, 200, 200, 200], 1)
    server = pkg.server.RetrievalServer(backend, max_wait_ms=150.0)
    server.warmup(_queries(8, 18), passes=1)
    qs = _with_parity(_queries(8, 19), lambda i: i in (0, 4))
    with server:
        backend.batch_costs = []
        for f in [server.submit(q) for q in qs]:
            f.result(timeout=60)
        costs, backend.batch_costs = backend.batch_costs, None
    exp_tiles = [tuple(c) for c in costs if 200 in c]
    assert exp_tiles and exp_tiles[0].count(200) == 2, costs
    assert sum(len(c) for c in costs) == len(qs)
    return {"batch_costs": costs}


def collect_from_one_queue(pkg):
    """``_collect`` over one pre-filled queue of costed requests (costs
    1 to 1,500 jobs, reorder horizon 2): the batches it forms, the stash
    included, until the queue is empty."""
    cls = _costed(pkg)
    costs = np.random.default_rng(20).choice([1, 70, 200, 700, 1500], 48)

    class ListCosted(cls):
        def request_cost(self, query):
            return int(query[1])

    _, _, backend = _setup(pkg, cls=ListCosted, widths=(2, 4, 8),
                           tile_slots_cap=2048)
    server = pkg.server.RetrievalServer(backend, max_wait_ms=1.0,
                                        reorder_horizon=2)
    for i, c in enumerate(costs):
        server._q.put(((i, int(c)), 10, Future(), 0.0))
    batches = []
    while server._stash or not server._q.empty():
        first = (server._stash.pop(0) if server._stash
                 else server._q.get_nowait())
        batches.append([item[0][0] for item in server._collect(first)])
    assert sorted(i for b in batches for i in b) == list(range(len(costs)))
    return {"batches": batches, "n_cost_splits": server.n_cost_splits}


SCENARIOS = (hot_lane_routes, hot_lane_mixed_stream, hot_flood_is_shed,
             cost_aware_split, expensive_class_grouped,
             collect_from_one_queue)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_admission_equals_reference(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want
