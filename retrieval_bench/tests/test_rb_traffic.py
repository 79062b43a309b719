"""The seeded generators repeat themselves, and every seed gets the same
amount of work in its own order."""

from __future__ import annotations

import numpy as np

from retrieval_bench import gen

HIST = {"3": 8, "4": 15, "5": 18, "6": 17, "12": 3}


def test_schedule_repeats_and_fills_the_window():
    a = gen.open_loop_schedule(400.0, 2.5, 2 ** 31 + 7)
    b = gen.open_loop_schedule(400.0, 2.5, 2 ** 31 + 7)
    np.testing.assert_array_equal(a, b)
    assert len(a) == 1000 and np.all(np.diff(a) > 0)
    assert 0 < a[0] and np.isclose(a[-1], 2.5)


def test_seeds_share_gaps_and_sizes_in_another_order():
    a = gen.open_loop_schedule(400.0, 2.5, 1)
    b = gen.open_loop_schedule(400.0, 2.5, 2)
    ga, gb = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
    assert not np.allclose(ga, gb)
    np.testing.assert_allclose(np.sort(ga), np.sort(gb), rtol=1e-8)
    bank = gen.word_bank(512, 256, 1)
    ta = gen.texts(HIST, 300, bank, 1)
    tb = gen.texts(HIST, 300, gen.word_bank(512, 256, 2), 2)
    assert ta != tb
    assert sorted(len(t.split()) for t in ta) == \
        sorted(len(t.split()) for t in tb)


def test_texts_repeat_are_distinct_and_from_the_bank():
    bank = gen.word_bank(512, 256, 3)
    t1 = gen.texts(HIST, 500, bank, 3)
    assert t1 == gen.texts(HIST, 500, bank, 3)
    assert len(set(t1)) == 500
    words = {int(w[1:]) for t in t1 for w in t.split()}
    assert words <= set(bank.tolist())


def test_fixed_counts_keeps_the_histogram():
    c = gen.fixed_counts(HIST, 61)
    assert len(c) == 61
    share = {k: np.mean(c == int(k)) for k in HIST}
    total = sum(HIST.values())
    for k, w in HIST.items():
        assert abs(share[k] - w / total) <= 1 / 61


def test_query_pool_repeats():
    a = gen.query_pool(1000, 50, 12, 16, 0.1, 2.0, 5)
    b = gen.query_pool(1000, 50, 12, 16, 0.1, 2.0, 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    qt, qv = a
    assert all(len(set(r[:12])) == 12 for r in qt)
    assert (qv[:, 12:] == 0).all() and (qv[:, :12] >= 0.1).all()


def test_weights_repeat_per_layer_and_differ_between_layers():
    m = {"hidden_size": 32, "intermediate_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "model_type": "qwen2", "vocab_size": 100}
    a = gen.layer_weights(m, 9, 1, "cpu")
    b = gen.layer_weights(m, 9, 1, "cpu")
    c = gen.layer_weights(m, 9, 2, "cpu")
    assert set(a) >= {"wq", "bq", "input_norm"}
    for k in a:
        assert (a[k] == b[k]).all()
    assert not (a["wq"] == c["wq"]).all()
