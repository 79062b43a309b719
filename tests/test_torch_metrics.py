"""The port's metrics (scaling_retriever_tpu_torch/evaluation/metrics.py)
against the JAX package's on seeded runs and qrels: every measure at every
cut, ``truncate_run``, MRR/recall helpers, the BEIR protocol and the EM/F1
helpers, exactly equal. Scores come from a small grid, so runs hold many
ties, which the trec_eval ordering (score desc, doc id desc) breaks."""

import json

import numpy as np
import pytest

from scaling_retriever_tpu.evaluation import metrics as ref
from scaling_retriever_tpu_torch.evaluation import metrics as port


def _run_qrel(seed, n_q=12, n_docs=60, depth=40):
    rng = np.random.default_rng(seed)
    run, qrel = {}, {}
    for q in range(n_q):
        docs = rng.choice(n_docs, depth, replace=False)
        run[f"q{q}"] = {f"d{d}": float(rng.integers(0, 8)) / 4
                        for d in docs}
        rel = rng.choice(n_docs, int(rng.integers(0, 6)), replace=False)
        qrel[f"q{q}"] = {f"d{d}": int(rng.integers(0, 3)) for d in rel}
    qrel["only_in_qrel"] = {"d1": 1}
    run["only_in_run"] = {"d1": 1.0}
    return run, qrel


@pytest.mark.parametrize("seed", [0, 1])
def test_measures_match_reference(seed):
    run, qrel = _run_qrel(seed)
    assert port.supported_measures == ref.supported_measures
    for metric in sorted(ref.supported_measures):
        for agg in (True, False):
            assert port.evaluate(run, qrel, metric, agg=agg) == \
                ref.evaluate(run, qrel, metric, agg=agg)
    assert port.evaluate(run, qrel, "recall", select="100") == \
        ref.evaluate(run, qrel, "recall", select="100")
    for k in (1, 5, 10, 1000):
        assert port.truncate_run(run, k) == ref.truncate_run(run, k)
        assert port.mrr_k(run, qrel, k) == ref.mrr_k(run, qrel, k)
        assert port.mrr_k(run, qrel, k, agg=False) == \
            ref.mrr_k(run, qrel, k, agg=False)
    for k in (5, 10, 100):
        assert port.recall_k(run, qrel, k) == ref.recall_k(run, qrel, k)
    for name in ("MRR@10", "recall@100", "recall@1000"):
        assert port.init_eval(name)(run, qrel) == ref.init_eval(name)(run,
                                                                      qrel)
    with pytest.raises(NotImplementedError):
        port.init_eval("P@3")
    # the BEIR protocol drops a doc that is the query itself
    run["q0"]["q0"] = 9.0
    assert port.evaluate_beir_run(run, qrel) == ref.evaluate_beir_run(run,
                                                                     qrel)


def test_files_and_answer_helpers_match_reference(tmp_path):
    run, qrel = _run_qrel(3)
    (tmp_path / "run.json").write_text(json.dumps(run))
    (tmp_path / "qrel.json").write_text(json.dumps(qrel))
    for metric in ("mrr_10", "recall", "ndcg_cut"):
        assert port.load_and_evaluate(str(tmp_path / "qrel.json"),
                                      str(tmp_path / "run.json"), metric) == \
            ref.load_and_evaluate(str(tmp_path / "qrel.json"),
                                  str(tmp_path / "run.json"), metric)
    got = port.evaluate_beir(str(tmp_path), qrel)
    with open(tmp_path / "perf.json") as f:
        assert json.load(f) == got == ref.evaluate_beir_run(run, qrel)
    pairs = [("The cat sat.", "the  CAT sat"), ("a b c", "b c d"),
             ("", "x"), ("An apple!", "apple")]
    for p, g in pairs:
        assert port.normalize_answer(p) == ref.normalize_answer(p)
        assert port.exact_match_score(p, g) == ref.exact_match_score(p, g)
        assert port.f1(p, g) == ref.f1(p, g)
    gts = [g for _, g in pairs]
    assert port.ems("cat sat", gts) == ref.ems("cat sat", gts)
    assert port.f1_with_gts("b c", gts) == ref.f1_with_gts("b c", gts)
