"""The plain reference of sparse retrieval over the uniform index: a
query's score of doc d is the sum, over its terms t with weight w > 0 and
over the postings of t's list that name d, of w * value (every value 1.0
here). Each list is regenerated from the index's definition
(``retrieval_bench.gen``), the scores summed into a dense [n_docs] vector
by ``index_add_``, and the top-k taken by ``torch.topk``: brute force
over every doc.

``precision="bf16"`` is the control: weights and sums in bfloat16, the
step below the f32 layout the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_bench import gen


def score_queries(ix: dict, vocab: int, terms: np.ndarray, vals: np.ndarray,
                  k: int, at_docs: list, device, precision: str = "f32"
                  ) -> list:
    """For each query row (terms, vals): its reference top-k scores and
    docs, how many docs score above 0, and its scores at ``at_docs[i]``
    (the docs a system under test returned)."""
    n_docs = ix["n_docs"]
    pt = gen.per_term(ix, vocab)
    span = torch.arange(pt, dtype=torch.int64, device=device)
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    out = []
    for i in range(len(terms)):
        keep = vals[i] > 0
        t = torch.as_tensor(terms[i][keep].astype(np.int64), device=device)
        w = torch.as_tensor(vals[i][keep].astype(np.float32), device=device)
        post = (t[:, None] * pt + span[None, :]).reshape(-1)
        docs = gen.doc_of_posting(post, n_docs)
        score = torch.zeros(n_docs, dtype=dt, device=device)
        score.index_add_(0, docs, w.to(dt).repeat_interleave(pt))
        score = score.float()
        top_s, top_d = torch.topk(score, min(k, n_docs))
        at = torch.as_tensor(np.asarray(at_docs[i], np.int64), device=device)
        out.append({"top_scores": top_s.cpu().numpy(),
                    "top_docs": top_d.cpu().numpy(),
                    "n_positive": int((score > 0).sum()),
                    "at": score[at].cpu().numpy()})
    return out
