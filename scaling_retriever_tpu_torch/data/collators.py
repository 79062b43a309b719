"""Collators (port of data/collators.py): the training collators, one per
loss's batch layout, the collection collators of (id, text) batches, and
the rerank collators of (qid, docid, ...) pairs, each tokenizing into
numpy arrays.

The tokenizer is any callable with the Hugging Face call protocol:
``tokenizer(texts, truncation=True, max_length=..., padding="longest" or
"max_length", pad_to_multiple_of=..., return_attention_mask=True)``
returning ``input_ids`` and ``attention_mask``. ``fixed_length`` pads to
``max_length`` (one tensor shape per length). ``target_labels`` is named so
to keep it apart from a trainer's own labels, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _tokenize(tokenizer, texts, max_length: int,
              pad_to_multiple_of: Optional[int], fixed_length: bool) -> dict:
    enc = tokenizer(list(texts), truncation=True, max_length=max_length,
                    padding="max_length" if fixed_length else "longest",
                    pad_to_multiple_of=None if fixed_length
                    else pad_to_multiple_of,
                    return_attention_mask=True)
    return {
        "input_ids": np.asarray(enc["input_ids"], np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], np.int32),
    }


class _Base:
    def __init__(self, tokenizer, query_max_length: int, doc_max_length: int,
                 pad_to_multiple_of: Optional[int] = 8,
                 fixed_length: bool = False):
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length
        self.doc_max_length = doc_max_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_length = fixed_length

    def _tok_q(self, texts):
        return _tokenize(self.tokenizer, texts, self.query_max_length,
                         self.pad_to_multiple_of, self.fixed_length)

    def _tok_d(self, texts):
        return _tokenize(self.tokenizer, texts, self.doc_max_length,
                         self.pad_to_multiple_of, self.fixed_length)


def _teacher(pos_score, neg_scores, n_negs: int) -> np.ndarray:
    teacher = np.asarray([[p] + list(n) for p, n in zip(pos_score,
                                                        neg_scores)],
                         np.float32)
    if teacher.shape != (len(pos_score), n_negs + 1):
        raise ValueError(f"teacher scores of shape {teacher.shape}, "
                         f"expected ({len(pos_score)}, {n_negs + 1})")
    return teacher


class LlamaSparseCollatorForNCE(_Base):
    """queries; contexts [pos..., then each query's negs]; labels arange."""

    def __call__(self, batch):
        queries, pos_texts, batch_neg_texts = [list(x) for x in zip(*batch)]
        texts = pos_texts + [n for negs in batch_neg_texts for n in negs]
        return {
            "tokenized_queries": self._tok_q(queries),
            "tokenized_contexts": self._tok_d(texts),
            "target_labels": np.arange(len(queries), dtype=np.int32),
        }


class LlamaSparseCollatorForKLDiv(_Base):
    """queries; contexts [pos, negs...] per query; teacher scores."""

    def __call__(self, batch):
        queries, pos_texts, batch_neg_texts, pos_score, neg_scores = \
            [list(x) for x in zip(*batch)]
        texts = []
        for pos, negs in zip(pos_texts, batch_neg_texts):
            texts.extend([pos] + list(negs))
        return {
            "tokenized_queries": self._tok_q(queries),
            "tokenized_contexts": self._tok_d(texts),
            "teacher_scores": _teacher(pos_score, neg_scores,
                                       len(batch_neg_texts[0])),
        }


class LlamaSparseCollatorForNCE_KLDiv(_Base):
    """The NCE layout plus teacher scores and ``teacher_idxes``, which map
    each query's [pos, negs...] to columns of the [bz, bz * (1 + n)]
    logits."""

    def __call__(self, batch):
        queries, pos_texts, batch_neg_texts, pos_score, neg_scores = \
            [list(x) for x in zip(*batch)]
        texts = pos_texts + [n for negs in batch_neg_texts for n in negs]
        bz, num_neg = len(queries), len(batch_neg_texts[0])
        teacher_idxes = np.asarray(
            [[i] + list(range(bz + i * num_neg, bz + (i + 1) * num_neg))
             for i in range(bz)], np.int32)
        return {
            "tokenized_queries": self._tok_q(queries),
            "tokenized_contexts": self._tok_d(texts),
            "target_labels": np.arange(bz, dtype=np.int32),
            "teacher_scores": _teacher(pos_score, neg_scores, num_neg),
            "teacher_idxes": teacher_idxes,
        }


class LlamaSparseCollatorForMarginMSE(_Base):
    """(query, pos, neg) and their teacher scores."""

    def __call__(self, batch):
        query, pos_doc, neg_doc, pos_score, neg_score = zip(*batch)
        return {
            "tokenized_query": self._tok_q(query),
            "pos_tokenized_doc": self._tok_d(pos_doc),
            "neg_tokenized_doc": self._tok_d(neg_doc),
            "teacher_pos_scores": np.asarray(pos_score, np.float32),
            "teacher_neg_scores": np.asarray(neg_score, np.float32),
        }


LlamaDenseCollatorForNCE = LlamaSparseCollatorForNCE
LlamaDenseCollatorForKLDiv = LlamaSparseCollatorForKLDiv
LlamaDenseCollatorForNCE_KLDiv = LlamaSparseCollatorForNCE_KLDiv
LlamaDenseCollatorForMarginMSE = LlamaSparseCollatorForMarginMSE
# T5: the same layouts; the decoder's input ids are the input ids, which
# T5Sparse.encode_pure sets itself
T5SparseCollatorForNCE = LlamaSparseCollatorForNCE
T5SparseCollatorForMarginMSE = LlamaSparseCollatorForMarginMSE


class LlamaSparseCollectionCollator:
    """(ids, texts) batches → {"input_ids", "attention_mask", "ids"}."""

    def __init__(self, tokenizer, max_length: int,
                 pad_to_multiple_of: Optional[int] = 8,
                 fixed_length: bool = False):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_length = fixed_length

    def __call__(self, batch):
        ids, texts = [list(x) for x in zip(*batch)]
        return {**_tokenize(self.tokenizer, texts, self.max_length,
                            self.pad_to_multiple_of, self.fixed_length),
                "ids": ids}


LlamaDenseCollectionCollator = LlamaSparseCollectionCollator
LlamaHybridCollectionCollator = LlamaSparseCollectionCollator
T5SparseCollectionCollator = LlamaSparseCollectionCollator


class HybridRetrieverRerankCollator(_Base):
    """(qid, docid, query, doc) pairs → ids and both sides tokenized."""

    def __call__(self, batch):
        qids, docids, queries, docs = [list(x) for x in zip(*batch)]
        return {
            "qids": qids,
            "docids": docids,
            "tokenized_queries": self._tok_q(queries),
            "tokenized_docs": self._tok_d(docs),
        }


class RerankerInferenceCollator:
    """(qid, docid, "prefixed query and doc" text) → one tokenized text per
    pair, for a cross-encoder."""

    def __init__(self, tokenizer, max_length: int, pad_to_multiple_of: int = 16,
                 fixed_length: bool = False):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_length = fixed_length

    def __call__(self, batch):
        qids, docids, text_pairs = [list(x) for x in zip(*batch)]
        toks = _tokenize(self.tokenizer, text_pairs, self.max_length,
                         self.pad_to_multiple_of, self.fixed_length)
        return {"qids": qids, "docids": docids, "tokenized_texts": toks}


class BertRerankerInferenceCollator:
    """(qid, docid, query, doc) → the (query, doc) pair tokenized together,
    with the tokenizer's token-type ids."""

    def __init__(self, tokenizer, max_length: int):
        self.tokenizer = tokenizer
        self.max_length = max_length

    def __call__(self, batch):
        qids, docids, queries, docs = [list(x) for x in zip(*batch)]
        enc = self.tokenizer(queries, docs, padding=True, truncation=True,
                             max_length=self.max_length)
        toks = {k: np.asarray(v) for k, v in enc.items()}
        return {"qids": qids, "docids": docids, "tokenized_texts": toks}


def tokenize_add_cls_token_id_and_padding(tokenizer, texts,
                                          max_length: int) -> dict:
    """Texts cut to ``max_length - 1`` tokens, the cls token appended, then
    left-padded to a multiple of 8 (the tokenizer must pad on the left)."""
    if tokenizer.padding_side != "left":
        raise ValueError(f"padding_side {tokenizer.padding_side!r}: the cls "
                         "token ends each row only under left padding")
    enc = tokenizer(list(texts), truncation=True, padding=False,
                    max_length=max_length - 1, return_attention_mask=False,
                    add_special_tokens=True)
    enc["input_ids"] = [ids + [tokenizer.cls_token_id]
                        for ids in enc["input_ids"]]
    padded = tokenizer.pad(enc, padding=True, pad_to_multiple_of=8,
                           return_attention_mask=True)
    return {
        "input_ids": np.asarray(padded["input_ids"], np.int32),
        "attention_mask": np.asarray(padded["attention_mask"], np.int32),
    }
