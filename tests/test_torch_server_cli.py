"""The port's dense serving backend, HTTP facade and server CLI
(scaling_retriever_tpu_torch/serving/server.py) against numpy oracles and
the JAX package's backend on the same index.

Dense data are dyadic (exact scores in f32 and bf16 in any summation
order): scores are compared bit-equal, ids tie-equal. The CLI's
``serve_http`` is swapped for a function that searches inside the running
server, as tests/test_serving.py does for the JAX CLI.
"""

import json
import queue
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index.dense_index import \
    DenseFlatIndexer as RefIndexer
from scaling_retriever_tpu.serving import server as ref_server
from scaling_retriever_tpu_torch.index.dense_index import DenseFlatIndexer
from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.serving import server as srv
from scaling_retriever_tpu_torch.serving.server import (
    DenseTileBackend, RetrievalServer, ServerOverloadedError, serve_http,
)
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

torch.set_num_threads(1)

D = 16


def _dyadic(rng, shape):
    return (rng.integers(-32, 33, shape) / 8.0).astype(np.float32)


def _dense_indexer(docs, **kw):
    ix = DenseFlatIndexer(device="cpu", **kw)
    ix.init_index(docs.shape[1])
    ix.index_data([(f"d{i}", docs[i]) for i in range(len(docs))])
    return ix


def _oracle(docs, q, k):
    s = docs @ q
    order = np.argsort(-s, kind="stable")[:k]
    return [f"d{r}" for r in order], s[order]


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_dense_backend_through_server(quantize):
    """Blocked selection, the 8 and 32 rungs: a lone request and a ragged
    5-wide tile (padded with copies of its first query), and a full tile;
    equal to the JAX backend's results on the same index, and to the
    numpy oracle (over the codes for int8)."""
    rng = np.random.default_rng(0)
    n, k = 1024, 12
    docs = _dyadic(rng, (n, D))
    kw = dict(chunk=512, sel_block=128, block_m=8, quantize=quantize)
    ix = _dense_indexer(docs, **kw)
    theirs = RefIndexer(**kw)
    theirs.init_index(D)
    theirs.index_data([(f"d{i}", docs[i]) for i in range(n)])
    assert ix._blocked(k)
    backend = DenseTileBackend(ix, topk=k, widths=(8, 32))
    ref_backend = ref_server.DenseTileBackend(theirs, topk=k, widths=(8, 32))
    qs = [_dyadic(rng, D) for _ in range(38)]
    packed = backend.pack(qs[:5])
    assert packed.shape == (8, D) and (packed[5:] == qs[0]).all()
    with RetrievalServer(backend, max_wait_ms=5.0) as server:
        lone = server.search(qs[0])
        futs = [server.submit(q) for q in qs[1:6]]
        ragged = [f.result(timeout=60) for f in futs]
        futs = [server.submit(q, topk=5) for q in qs[6:]]
        full = [f.result(timeout=60) for f in futs]
    assert ix.fallbacks == 0
    got = [lone] + ragged + full
    for i, (q, (ids, sc)) in enumerate(zip(qs, got)):
        want = ref_backend.drain(ref_backend.dispatch([q]), [q])[0]
        kk = 5 if i >= 6 else k
        assert np.asarray(sc, np.float32).tobytes() == \
            np.asarray(want[1][:kk], np.float32).tobytes()
        tie_equal_topk(ids, sc, want[0][:kk], want[1][:kk], rtol=0.0)
        if quantize is None:
            tie_equal_topk(ids, sc, *(_oracle(docs, q, kk)), rtol=0.0)


def test_dense_backend_sync_object():
    """An object with only ``search_knn`` runs in drain."""
    rng = np.random.default_rng(1)
    docs = _dyadic(rng, (40, D))
    ix = _dense_indexer(docs, chunk=64, selection="direct")

    class SyncOnly:
        def search_knn(self, q, k):
            return ix.search_knn(q, k)

    backend = DenseTileBackend(SyncOnly(), width=8, topk=5)
    q = _dyadic(rng, D)
    with RetrievalServer(backend) as server:
        ids, scores = server.search(q)
    tie_equal_topk(ids, scores, *_oracle(docs, q, 5), rtol=0.0)


def _post(base, body):
    req = urllib.request.Request(f"{base}/search",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def test_serve_http_post_get_and_429():
    rng = np.random.default_rng(2)
    docs = _dyadic(rng, (200, D))
    ix = _dense_indexer(docs, chunk=256, selection="direct")
    server = RetrievalServer(DenseTileBackend(ix, topk=10, widths=(8,)),
                             max_wait_ms=1.0).start()
    httpd = serve_http(server, port=0, block=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        qs = [_dyadic(rng, D) for _ in range(3)]
        res = _post(base, {"queries": [{"id": f"q{i}",
                                        "vector": q.tolist()}
                                       for i, q in enumerate(qs)],
                           "topk": 4})["results"]
        for i, q in enumerate(qs):
            ids, sc = server.search(q, topk=4)
            assert res[f"q{i}"] == dict(zip(ids, sc))
            tie_equal_topk(list(res[f"q{i}"]), list(res[f"q{i}"].values()),
                           *_oracle(docs, q, 4), rtol=0.0)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            assert json.load(r)["n_requests"] >= 6
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"queries": [{"id": "t", "text": "w1 w2"}]})
        assert ei.value.code == 400 and "frontend" in json.load(ei.value)[
            "error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
        # a full fast queue sheds as 429 (the facade's submit never blocks
        # past its timeout)
        httpd_fast = serve_http(server, port=0, block=False,
                                submit_timeout_s=0)
        t2 = threading.Thread(target=httpd_fast.serve_forever, daemon=True)
        t2.start()
        old_q = server._q
        server._q = queue.Queue(maxsize=1)
        server._q.put(("filler",) * 4)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"http://127.0.0.1:{httpd_fast.server_address[1]}",
                      {"queries": [{"id": "q", "vector": qs[0].tolist()}]})
            assert ei.value.code == 429
            assert "overloaded" in json.load(ei.value)["error"]
        finally:
            server._q.get_nowait()
            server._q = old_q
            httpd_fast.shutdown()
            httpd_fast.server_close()
        assert server.stats()["n_fast_shed"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    with pytest.raises(ServerOverloadedError):
        raise ServerOverloadedError("x")


class _Httpd:
    """What ``main`` uses of the server ``serve_http`` binds: its bound
    address, and ``serve_forever``, which here runs ``fn`` inside the
    started RetrievalServer and returns."""
    server_address = ("127.0.0.1", 5123)

    def __init__(self, fn):
        self.fn = fn

    def serve_forever(self):
        self.fn()

    def server_close(self):
        pass


def test_cli_dense_wiring(tmp_path, monkeypatch, capsys):
    """--dense_index_dir over an index the JAX package serialized, int8
    layout, a warmup npz of reps, 8-wide tiles."""
    rng = np.random.default_rng(3)
    docs = _dyadic(rng, (20, 8))
    theirs = RefIndexer(dtype=jnp.float32, query_tile=4, chunk=32,
                        selection="direct")
    theirs.init_index(8)
    theirs.index_data([(f"d{i}", docs[i]) for i in range(20)])
    d = tmp_path / "dense"
    theirs.serialize(str(d))
    np.savez(tmp_path / "warm.npz", reps=_dyadic(rng, (3, 8)))
    q = _dyadic(rng, 8)
    captured = {}

    def fake_serve(server, host, port, block=True, frontend=None):
        assert not block

        def run():
            captured["res"] = server.search(q)
            captured["backend"] = server.backend
        return _Httpd(run)

    monkeypatch.setattr(srv, "serve_http", fake_serve)
    for quant in ("none", "int8"):
        srv.main(["--dense_index_dir", str(d), "--topk", "5", "--width", "4",
                  "--dense_quantize", quant, "--device", "cpu",
                  "--warmup_queries", str(tmp_path / "warm.npz")])
        # the line names the bound port (the one --port 0 leaves to the
        # system)
        assert "serving on http://127.0.0.1:5123" in capsys.readouterr().err
        ids, scores = captured["res"]
        ix = captured["backend"].indexer
        assert ix.device.type == "cpu" and ix.ntotal == 20
        assert ix.quantize == (None if quant == "none" else "int8")
        want = _oracle(docs, q, 5)
        if quant == "none":
            assert ids == want[0]
            np.testing.assert_array_equal(np.asarray(scores, np.float32),
                                          want[1])
        else:
            assert len(ids) == 5


def test_cli_sparse_wiring_with_cpp_hot_lane(tmp_path, monkeypatch):
    """--index_dir with the default --hot_lane cpp and a --max_need_jobs
    of 0: every query with postings rides the host lane; its answers equal
    the brute force; --hot_lane none rejects it."""
    rng = np.random.default_rng(4)
    V, n = 40, 50
    rows = np.repeat(np.arange(n), 6)
    cols = np.concatenate([rng.choice(V, 6, replace=False) for _ in range(n)])
    vals = (rng.integers(1, 9, rows.size) / 4.0).astype(np.float32)
    idx = SparseIndex.from_triples(rows, cols, vals,
                                   [f"d{i}" for i in range(n)], V)
    idx.save(str(tmp_path / "idx"))
    terms = np.array([3, 7, 11], np.int32)
    qv = np.array([1.0, 0.5, 2.0], np.float32)
    dense = np.zeros((n, V), np.float32)
    dense[rows, cols] = vals
    s = dense[:, terms] @ qv
    order = np.argsort(-s, kind="stable")
    order = order[s[order] > 0][:10]
    captured = {}

    def fake_serve(server, host, port, block=True, frontend=None):
        assert not block

        def run():
            captured["res"] = server.search((terms, qv))
            captured["stats"] = server.stats()
        return _Httpd(run)

    monkeypatch.setattr(srv, "serve_http", fake_serve)
    base = ["--index_dir", str(tmp_path / "idx"), "--topk", "10",
            "--width", "4", "--device", "cpu"]
    srv.main(base + ["--max_need_jobs", "0"])
    ids, scores = captured["res"]
    assert captured["stats"]["n_hot"] == 1
    assert np.asarray(scores, np.float32).tobytes() == s[order].tobytes()
    tie_equal_topk(ids, scores, [f"d{r}" for r in order], s[order], rtol=0.0)
    srv.main(base)                                 # the device lane
    assert captured["stats"]["n_hot"] == 0
    tie_equal_topk(*captured["res"], [f"d{r}" for r in order], s[order],
                   rtol=0.0)
    with pytest.raises(ValueError, match="hot_lane"):
        srv.main(base + ["--max_need_jobs", "0", "--hot_lane", "none"])
    # text queries load their checkpoint from disk (a directory without
    # one fails there, before serving)
    with pytest.raises(OSError):
        srv.main(base + ["--model_name_or_path", str(tmp_path / "none")])
    with pytest.raises(SystemExit):
        srv.main(["--device", "cpu"])
    assert srv.build_parser().parse_args([]).device == "cuda"
