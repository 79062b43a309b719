"""The plain reference against the port at a tiny size on the CPU: the
decoder against the port's encoder run in float32, the brute-force
scorer against the port's engine."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from retrieval_bench import check, gen, program
from retrieval_bench.archs import bidir_decoder
from retrieval_bench.kinds.stream import served_rows
from retrieval_bench.reference import decoder, scoring
from retrieval_bench.tests.helpers import SEED, tiny_conf


@pytest.mark.parametrize("cell", ["qwen2-1.5b", "mistral-7b"])
def test_decoder_matches_the_port_encoder_in_f32(cell):
    conf = tiny_conf(cell)
    m = conf["model"]
    enc = bidir_decoder.build_encoder(conf, SEED, "cpu", dtype=torch.float32,
                                      param_dtype=torch.float32)
    r = gen.rng(SEED, 1)
    toks = [r.integers(2, m["vocab_size"], n).tolist()
            for n in (1, 3, 7, 12, 16)]
    tok = gen.StandInTokenizer(m["vocab_size"], (16,))
    ids, mask = tok([" ".join(f"w{t}" for t in ts) for ts in toks])
    port = enc.encode(ids, mask).numpy()
    ref = decoder.sparse_reps(m, SEED, toks, "cpu").numpy()
    assert (ref > 0).sum() > 0.2 * ref.size
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=2e-5)


def test_the_fp8_control_departs_from_the_reference():
    m = tiny_conf("qwen2-1.5b")["model"]
    toks = [[5, 9, 11, 300], [7, 8]]
    ref = decoder.sparse_reps(m, SEED, toks, "cpu")
    low = decoder.sparse_reps(m, SEED, toks, "cpu", precision="fp8")
    err = (low - ref).abs().max() / ref.max()
    assert 1e-3 < float(err) < 0.5


def test_scoring_matches_the_port_engine():
    conf = tiny_conf("mistral-7b")
    ix, vocab, k = conf["index"], conf["model"]["vocab_size"], 50
    engine = program.build_engine(conf, k, 16, "cpu")
    qt, qv = gen.query_pool(vocab, 8, 12, 16, 0.1, 2.0, SEED)
    s, rows = engine.finalize(engine.retrieve_tile_async(
        None, k, sparsified=(qt, qv)))
    served = [served_rows(s[i], rows[i], ix["n_docs"]) for i in range(8)]
    refs = scoring.score_queries(ix, vocab, qt, qv, k,
                                 [x[0] for x in served], "cpu")
    for (docs, sc), ref in zip(served, refs):
        assert len(docs) == k
        np.testing.assert_allclose(np.sort(sc), np.sort(ref["top_scores"]),
                                   rtol=1e-6)
    nums = check.engine_numbers(served, refs, k)
    assert nums["engine_score_err"] < 1e-6
    assert nums["engine_rank_gap"] < 1e-6
