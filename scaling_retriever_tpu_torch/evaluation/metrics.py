"""IR metrics, trec_eval-compatible, in pure Python (port of
evaluation/metrics.py). Semantics follow trec_eval:

  * runs are ranked by (score desc, doc_id desc), trec_eval's tie-break;
  * ``recip_rank``: 1/rank of the first doc with rel > 0;
  * ``recall_k``: |relevant ∩ top-k| / |relevant| (rel > 0);
  * ``ndcg_cut_k``: linear-gain DCG (rel / log2(rank+1)) over the run,
    normalized by the ideal DCG over the qrel;
  * ``map_cut_k`` and ``P_k``;
  * ``r_cap_k``: capped recall |rel ∩ top-k| / min(k, |rel|) (BEIR's
    "r_cap", used by evaluate_beir).

Evaluation iterates over the queries in both the run and the qrel.
"""

from __future__ import annotations

import json
import math
import os
from collections import Counter
from typing import Dict, Optional

STANDARD_CUTS = (5, 10, 15, 20, 30, 100, 200, 500, 1000)


def _ranked_docs(doc_scores: Dict[str, float]) -> list:
    """trec_eval ordering: score desc, then doc id desc."""
    return [d for d, _ in sorted(doc_scores.items(),
                                 key=lambda kv: (kv[1], kv[0]), reverse=True)]


def truncate_run(run: dict, k: int) -> dict:
    """Top-k truncation by the trec_eval ordering."""
    out = {}
    for qid, docs in run.items():
        ranked = _ranked_docs(docs)[:k]
        out[qid] = {d: docs[d] for d in ranked}
    return out


def _per_query(run: dict, qrel: dict):
    for qid, docs in run.items():
        if qid not in qrel:
            continue
        rels = {d: r for d, r in qrel[qid].items()}
        yield qid, _ranked_docs(docs), rels


def recip_rank(ranked: list, rels: dict) -> float:
    for i, d in enumerate(ranked):
        if rels.get(d, 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def recall_at(ranked: list, rels: dict, k: int) -> float:
    n_rel = sum(1 for r in rels.values() if r > 0)
    if n_rel == 0:
        return 0.0
    hits = sum(1 for d in ranked[:k] if rels.get(d, 0) > 0)
    return hits / n_rel


def r_cap_at(ranked: list, rels: dict, k: int) -> float:
    n_rel = sum(1 for r in rels.values() if r > 0)
    if n_rel == 0:
        return 0.0
    hits = sum(1 for d in ranked[:k] if rels.get(d, 0) > 0)
    return hits / min(k, n_rel)


def precision_at(ranked: list, rels: dict, k: int) -> float:
    hits = sum(1 for d in ranked[:k] if rels.get(d, 0) > 0)
    return hits / k


def ndcg_cut_at(ranked: list, rels: dict, k: int) -> float:
    dcg = 0.0
    for i, d in enumerate(ranked[:k]):
        rel = rels.get(d, 0)
        if rel > 0:
            dcg += rel / math.log2(i + 2)
    ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
    idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def map_cut_at(ranked: list, rels: dict, k: int) -> float:
    n_rel = sum(1 for r in rels.values() if r > 0)
    if n_rel == 0:
        return 0.0
    hits, ap = 0, 0.0
    for i, d in enumerate(ranked[:k]):
        if rels.get(d, 0) > 0:
            hits += 1
            ap += hits / (i + 1)
    return ap / n_rel


_MEASURES = {
    "recip_rank": lambda ranked, rels: {"recip_rank": recip_rank(ranked, rels)},
    "recall": lambda ranked, rels: {f"recall_{k}": recall_at(ranked, rels, k)
                                    for k in STANDARD_CUTS},
    "ndcg_cut": lambda ranked, rels: {f"ndcg_cut_{k}": ndcg_cut_at(ranked, rels, k)
                                      for k in STANDARD_CUTS},
    "map_cut": lambda ranked, rels: {f"map_cut_{k}": map_cut_at(ranked, rels, k)
                                     for k in STANDARD_CUTS},
    "P": lambda ranked, rels: {f"P_{k}": precision_at(ranked, rels, k)
                               for k in STANDARD_CUTS},
    "r_cap": lambda ranked, rels: {f"r_cap_{k}": r_cap_at(ranked, rels, k)
                                   for k in STANDARD_CUTS},
}

supported_measures = set(_MEASURES)


def evaluate_per_query(run: dict, qrel: dict, metric: str) -> dict:
    assert metric in _MEASURES, f"provide valid metric (one of {sorted(_MEASURES)})"
    fn = _MEASURES[metric]
    return {qid: fn(ranked, rels) for qid, ranked, rels in _per_query(run, qrel)}


def evaluate(run: dict, qrel: dict, metric: str, agg: bool = True,
             select: Optional[str] = None):
    """Metric averaged over queries (``agg``), or per query."""
    out_eval = evaluate_per_query(run, qrel, metric)
    if not agg:
        return out_eval
    res: Counter = Counter()
    for d in out_eval.values():
        res += Counter(d)
    res = {k: v / max(1, len(out_eval)) for k, v in res.items()}
    if select is not None:
        return res.get(f"{metric}_{select}", 0)
    return res


def mrr_k(run: dict, qrel: dict, k: int, agg: bool = True):
    """MRR over the top-k truncated run."""
    truncated = truncate_run(run, k)
    per_q = evaluate_per_query(truncated, qrel, "recip_rank")
    if agg:
        return sum(d["recip_rank"] for d in per_q.values()) / max(1, len(per_q))
    return per_q


def recall_k(run: dict, qrel: dict, k: int, agg: bool = True):
    """Mean recall at k; agg=False returns per-query values."""
    per_q = evaluate_per_query(run, qrel, "recall")
    if agg:
        total = sum(d[f"recall_{k}"] for d in per_q.values())
        return total / max(1, len(per_q))
    return per_q


def load_and_evaluate(qrel_file_path: str, run_file_path: str, metric: str) -> dict:
    """Evaluate a run.json against a qrel json (a TREC qrel path must name
    its binary form exactly when the metric is not nDCG)."""
    with open(qrel_file_path) as f:
        qrel = json.load(f)
    with open(run_file_path) as f:
        run = json.load(f)
    if "TREC" in qrel_file_path:
        assert ("binary" not in qrel_file_path) == (metric in ("ndcg", "ndcg_cut")), \
            (qrel_file_path, metric)
    if metric == "mrr_10":
        res = mrr_k(run, qrel, k=10)
        print("MRR@10:", res)
        return {"mrr_10": res}
    res = evaluate(run, qrel, metric=metric)
    print(metric, "==>", res)
    return res


def init_eval(metric: str):
    """A run x qrel -> float evaluator for "MRR@10" or "recall@k"."""
    valid = ["MRR@10"] + [f"recall@{k}" for k in (10, 50, 100, 200, 500, 1000)]
    if metric not in valid:
        raise NotImplementedError("provide valid metric")
    if metric == "MRR@10":
        return lambda run, qrel: mrr_k(run, qrel, k=10, agg=True)
    cut = metric.split("@")[1]
    return lambda run, qrel: evaluate(run, qrel, metric="recall", agg=True, select=cut)


def evaluate_beir_run(run: dict, qrels: dict) -> dict:
    """BEIR protocol: drop self-matches, NDCG@10 / Recall@100 /
    R_cap@100."""
    new_run = {qid: {d: s for d, s in docs.items() if d != qid}
               for qid, docs in run.items()}
    ndcg = evaluate(new_run, qrels, "ndcg_cut")
    recall = evaluate(new_run, qrels, "recall")
    r_cap = evaluate(new_run, qrels, "r_cap")
    return {
        "NDCG@10": ndcg.get("ndcg_cut_10", 0),
        "Recall@100": recall.get("recall_100", 0),
        "R_cap@100": r_cap.get("r_cap_100", 0),
    }


def evaluate_beir(out_dir: str, qrels: dict) -> dict:
    with open(os.path.join(out_dir, "run.json")) as f:
        run = json.load(f)
    res = evaluate_beir_run(run, qrels)
    with open(os.path.join(out_dir, "perf.json"), "w") as f:
        json.dump(res, f, indent=4)
    return res


# ---------------------------------------------------------------------------
# SQuAD-style answer metrics (for wiki/QA evaluations)
# ---------------------------------------------------------------------------

def normalize_answer(s: str) -> str:
    import re
    import string

    def remove_articles(text):
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text):
        return " ".join(text.split())

    def remove_punc(text):
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def ems(prediction: str, ground_truths) -> bool:
    return max(exact_match_score(prediction, gt) for gt in ground_truths)


def f1(prediction: str, ground_truth: str) -> float:
    pred_tokens = normalize_answer(prediction).split()
    gt_tokens = normalize_answer(ground_truth).split()
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def f1_with_gts(prediction: str, ground_truths) -> float:
    return max(f1(prediction, gt) for gt in ground_truths)
