"""TermEncoderRetriever (port of index/term_encoder.py): score docs given
as fixed-length term codes.

Each doc is a code ``smtids`` of length 16, 32, 64 or 128; its score for a
query is ``pred_scores[:, smtids].sum(-1)``. That is the doc-major scan of
``ops/sparse_scoring.py`` with K = L and every value 1, so the scores and
the running top-k come from ``score_doc_major`` / ``retrieve_doc_major``
over the codes, on ``device`` (default "cuda"). ``lex_encode`` is the
model's when it has one; otherwise ``encode``, its first output for a
hybrid model.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from scaling_retriever_tpu_torch.ops.sparse_scoring import (
    pad_docs, retrieve_doc_major, score_doc_major)
from scaling_retriever_tpu_torch.utils.run_accum import RunAccumulator

CODE_LENGTHS = (16, 32, 64, 128)


class TermEncoderRetriever:
    def __init__(self, model, args=None, block: int = 4096, device="cuda"):
        self.model = model
        self.args = args
        self.block = block
        self.device = torch.device(device)

    def _lex_encode(self, batch) -> torch.Tensor:
        if hasattr(self.model, "lex_encode"):
            reps = self.model.lex_encode(batch["input_ids"],
                                         batch["attention_mask"])
        else:
            reps = self.model.encode(batch["input_ids"],
                                     batch["attention_mask"])
            if isinstance(reps, tuple):    # hybrid models: lexical head
                reps = reps[0]
        return torch.as_tensor(reps).to(self.device, torch.float32)

    def _codes(self, doc_encodings) -> tuple[torch.Tensor, torch.Tensor]:
        terms = torch.as_tensor(np.asarray(doc_encodings, np.int32),
                                device=self.device)
        return pad_docs(terms, torch.ones(terms.shape, device=self.device),
                        self.block)

    def get_doc_scores(self, pred_scores, doc_encodings) -> np.ndarray:
        """pred_scores [bz, V]; doc_encodings [N, L] → scores [bz, N]."""
        terms, vals = self._codes(doc_encodings)
        q_t = torch.as_tensor(pred_scores).to(self.device, torch.float32).T
        scores = score_doc_major(terms, vals, q_t.contiguous(),
                                 block=self.block)
        return scores[:len(doc_encodings)].T.cpu().numpy()

    def retrieve(self, collection_loader: Iterable, docid_to_smtids: dict,
                 topk: int, out_dir: str, use_fp16: bool = False,
                 run_name: Optional[str] = None) -> dict:
        """Every query batch's top-``topk`` docs into ``out_dir/run_name``
        (``run.json``); a query with no positive score keeps an empty
        entry."""
        os.makedirs(out_dir, exist_ok=True)
        docids = list(docid_to_smtids)
        codes = list(docid_to_smtids.values())
        for smtids in codes:
            if len(smtids) not in CODE_LENGTHS:
                raise ValueError(f"a code of length {len(smtids)}; the "
                                 f"lengths are {CODE_LENGTHS}")
        terms, vals = self._codes(codes)
        n_docs = len(docids)
        all_qids: list = []
        acc = RunAccumulator(all_qids, docids, n_docs, threshold=None,
                             keep_empty=True)
        for batch in collection_loader:
            preds = self._lex_encode(batch)
            scores, rows = retrieve_doc_major(
                terms, vals, preds.T.contiguous(), k=min(topk, n_docs),
                block=self.block)
            qids = batch.get("queries", batch.get("ids"))
            start = len(all_qids)
            all_qids.extend(qids)
            acc.add_tile(np.arange(start, start + len(qids)),
                         rows.cpu().numpy(), scores.cpu().numpy())
        run = acc.to_run()
        with open(os.path.join(out_dir, run_name or "run.json"), "w") as f:
            json.dump(run, f)
        return run
