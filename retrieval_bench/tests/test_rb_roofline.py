"""The roofline's count of bytes against the index's own offsets, and
the trace arithmetic on records."""

from __future__ import annotations

import numpy as np

from retrieval_bench import flops, gen, readers
from retrieval_bench.trace import (Summary, idle_gaps, merged,
                                   span_device_ns, top_ops)


def test_retrieval_bytes_count_each_posting_of_each_term_once():
    ix = {"n_docs": 3000, "postings_per_doc": 16}
    vocab = 200
    rows, bits, offsets, nnz = gen.index_rows(ix, vocab, "cpu")
    assert nnz == offsets[-1] == gen.per_term(ix, vocab) * vocab
    assert rows.shape[0] == nnz + gen.PAD and (rows[nnz:] == 3000).all()
    qt, qv = gen.query_pool(vocab, 5, 12, 16, 0.1, 2.0, 4)
    lens = (offsets[qt + 1] - offsets[qt]) * (qv > 0)
    k = 10
    want = int(lens.sum()) * 8 + 5 * k * 8
    pt = gen.per_term(ix, vocab)
    assert flops.retrieval_bytes(int((qv > 0).sum()) * pt, 5, k) == want


def test_every_posting_is_a_doc_of_the_index():
    ix = {"n_docs": 3000, "postings_per_doc": 16}
    rows, bits, offsets, nnz = gen.index_rows(ix, 200, "cpu")
    assert int(rows[:nnz].min()) >= 0 and int(rows[:nnz].max()) < 3000
    assert (bits[:nnz] == int(np.float32(1.0).view(np.int32))).all()


def test_busy_idle_and_span_device_time():
    device = [(10, 20, "k1", 1), (15, 30, "k2", 2), (50, 60, "k1", 3),
              (95, 120, "k3", 4)]
    spans = [("rb.engine", 0, 12, 7), ("rb.encode", 40, 55, 8)]
    launches = {1: (5, 7), 2: (13, 7), 3: (45, 8), 4: (90, 8)}
    assert merged(device, 0, 100) == [[10, 30], [50, 60], [95, 100]]
    s = Summary((0, 100), device, spans, launches)
    assert s.busy_s() == 35 / 1e9
    assert span_device_ns(device, spans, launches, {"rb.engine"}) == 10
    assert span_device_ns(device, spans, launches, {"rb.encode"}) == 10
    assert top_ops(device, 0, 100, 2)[0] == ["k1", 20 / 1e9]
    gaps = dict(idle_gaps(device, spans, 0, 100, 10))
    assert gaps == {"rb.engine": 10 / 1e9, "rb.encode": 20 / 1e9,
                    "no span": 35 / 1e9}
    rec = {"trace": s, "retrieval_bytes": 3.35e12 * 5e-9,
           "retrieval_spans": ("rb.engine",)}
    assert abs(readers.retrieval_roofline(rec) - 50.0) < 1e-9
    assert abs(readers.device_idle(rec) - 65.0) < 1e-9


def test_readers_return_nothing_without_a_trace():
    rec = {"trace": None, "retrieval_bytes": 10, "retrieval_spans": ()}
    assert readers.retrieval_roofline(rec) is None
    assert readers.device_idle(rec) is None
    assert readers.mfu({"flops": 0, "window_s": 1.0}) is None


def test_encode_flops_by_hand():
    m = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
         "num_attention_heads": 2, "num_key_value_heads": 1,
         "vocab_size": 10}
    # multiply-adds a token: q and o 2*8*8, k and v 2*8*4, mlp 3*8*16;
    # attention 2 * n * 8 each for QK^T and PV; head 8*10
    n = 3
    layer = 2 * n * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16) + 4 * n * n * 8
    head = 2 * n * 8 * 10
    assert flops.encode_flops(m, n) == 2 * layer + head
    assert flops.train_flops(m, [(1, n)], False) == 2 * 2 * layer + 2 * head
    assert flops.train_flops(m, [(1, n)], True) == 3 * 2 * layer + 2 * head
