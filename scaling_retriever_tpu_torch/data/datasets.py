"""Map-style datasets (port of data/datasets.py): the training datasets,
which draw negatives with Python's ``random.Random(seed)`` as the
reference does (so both packages draw the same ones), and the inference
datasets, and the rerank datasets of (qid, docid) pairs. Any object with
``__len__``/``__getitem__`` feeds ``data/loader.py``'s DataLoader."""

from __future__ import annotations

import json
import random
from typing import Optional, Sequence

from scaling_retriever_tpu_torch.data.io import (
    get_doc_text, load_beir_dataset, read_msmarco_corpus, read_msmarco_query,
    read_wiki_corpus,
)


def _read_corpus(corpus_path: str, data_source: str):
    if data_source == "wiki":
        return read_wiki_corpus(corpus_path)
    if data_source == "msmarco":
        return read_msmarco_corpus(corpus_path)
    raise ValueError("data_source must be either wiki or msmarco")


class DualEncoderDatasetForNCE:
    """(query, pos_text, [neg_texts]), negatives drawn afresh per item."""

    def __init__(self, corpus_path: str, train_path: str, data_source: str,
                 n_negs: int = 1, seed: Optional[int] = None):
        self.pid_to_doc = _read_corpus(corpus_path, data_source)
        self.examples = []
        with open(train_path) as fin:
            for line in fin:
                ex = json.loads(line)
                self.examples.append((ex["question"], ex["pos_pid"],
                                      ex["neg_pids"]))
        self.n_negs = n_negs
        self.data_source = data_source
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx):
        query, pos_pid, neg_pids = self.examples[idx]
        if self.data_source == "wiki" and len(neg_pids) < self.n_negs:
            # wiki can run short of negatives: draw with replacement
            sample_neg_pids = self.rng.choices(neg_pids, k=self.n_negs)
        else:
            sample_neg_pids = self.rng.sample(neg_pids, k=self.n_negs)
        pos_text = get_doc_text(*self.pid_to_doc[pos_pid])
        neg_texts = [get_doc_text(*self.pid_to_doc[p])
                     for p in sample_neg_pids]
        return query, pos_text, neg_texts


class DualEncoderDatasetForMarginMSE:
    """(query, pos_doc, a random neg_doc, pos_score, neg_score)."""

    def __init__(self, corpus_path: str, train_path: str, data_source: str,
                 seed: Optional[int] = None):
        self.pid_to_doc = _read_corpus(corpus_path, data_source)
        with open(train_path) as fin:
            self.examples = [json.loads(line) for line in fin]
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx):
        ex = self.examples[idx]
        query, docids, scores = ex["query"], ex["docids"], ex["scores"]
        neg_idx = self.rng.randrange(1, len(docids))
        return (query, get_doc_text(*self.pid_to_doc[docids[0]]),
                get_doc_text(*self.pid_to_doc[docids[neg_idx]]), scores[0],
                scores[neg_idx])


class DualEncoderDatasetForKLDiv:
    """(query, pos, [negs], pos_score, [neg_scores]); MSMARCO only."""

    def __init__(self, corpus_path: str, train_path: str, data_source: str,
                 n_negs: int = 1, seed: Optional[int] = None):
        if data_source != "msmarco":
            raise ValueError("data_source must be either wiki or msmarco")
        self.pid_to_doc = read_msmarco_corpus(corpus_path)
        self.examples = []
        with open(train_path) as fin:
            for line in fin:
                ex = json.loads(line)
                self.examples.append((ex["question"], ex["pos_pid"],
                                      ex["neg_pids"], ex["pos_score"],
                                      ex["neg_scores"]))
        self.n_negs = n_negs
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx):
        query, pos_pid, neg_pids, pos_score, neg_scores = self.examples[idx]
        if len(neg_pids) != len(neg_scores):
            raise ValueError(f"example {idx}: {len(neg_pids)} negatives, "
                             f"{len(neg_scores)} scores")
        sel = self.rng.sample(range(len(neg_pids)), k=self.n_negs)
        neg_texts = [get_doc_text(*self.pid_to_doc[neg_pids[i]]) for i in sel]
        return (query, get_doc_text(*self.pid_to_doc[pos_pid]), neg_texts,
                pos_score, [neg_scores[i] for i in sel])


class CollectionDataset:
    """(pid, doc_text) over the whole corpus."""

    def __init__(self, corpus_path: str, data_source: Optional[str] = None):
        self.pid_to_doc = _read_corpus(corpus_path, data_source)
        self.pids = list(self.pid_to_doc.keys())

    def __len__(self):
        return len(self.pids)

    def __getitem__(self, idx):
        pid = self.pids[idx]
        return pid, get_doc_text(*self.pid_to_doc[pid])


class WikiQueryDataset:
    """(query, query): wiki queries have no ids."""

    def __init__(self, query_path: str):
        self.queries = []
        with open(query_path) as fin:
            for line in fin:
                self.queries.append(line.rstrip("\n").split("\t")[0])

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, idx):
        return self.queries[idx], self.queries[idx]


class MSMARCOQueryDataset:
    """(qid, query)."""

    def __init__(self, query_path: str):
        self.qid_to_query = read_msmarco_query(query_path)
        self.qids = list(self.qid_to_query.keys())

    def __len__(self):
        return len(self.qids)

    def __getitem__(self, idx):
        qid = self.qids[idx]
        return qid, self.qid_to_query[qid]


class HybridRetrieverRerankDataset:
    """(qid, pid, query, doc) per pair, for bi-encoder reranking."""

    def __init__(self, qid_pid_pairs: Sequence, query_path: str,
                 corpus_path: str, data_source: Optional[str] = None):
        self.qid_pid_pairs = list(qid_pid_pairs)
        if data_source == "msmarco":
            self.pid_to_doc = read_msmarco_corpus(corpus_path)
        elif data_source == "wiki":
            self.pid_to_doc = read_wiki_corpus(corpus_path)
        else:
            raise ValueError(data_source)
        self.qid_to_query = read_msmarco_query(query_path)

    def __len__(self):
        return len(self.qid_pid_pairs)

    def __getitem__(self, idx):
        qid, pid = self.qid_pid_pairs[idx]
        return (qid, pid, self.qid_to_query[qid],
                get_doc_text(*self.pid_to_doc[pid]))


class RerankerInferenceDataset:
    """(qid, pid, "query_prefix q doc_prefix d") per pair, for
    cross-encoders; both prefixes are required."""

    def __init__(self, qid_pid_pairs: Sequence, query_path: str,
                 corpus_path: str, query_prefix: Optional[str] = None,
                 doc_prefix: Optional[str] = None):
        self.qid_pid_pairs = list(qid_pid_pairs)
        self.qid_to_query = read_msmarco_query(query_path)
        self.pid_to_doc = read_msmarco_corpus(corpus_path)
        if query_prefix is None or doc_prefix is None:
            raise ValueError("query_prefix and doc_prefix are required")
        self.query_prefix = query_prefix
        self.doc_prefix = doc_prefix

    def __len__(self):
        return len(self.qid_pid_pairs)

    def __getitem__(self, idx):
        qid, pid = self.qid_pid_pairs[idx]
        query = self.qid_to_query[qid]
        doc = get_doc_text(*self.pid_to_doc[pid])
        return qid, pid, f"{self.query_prefix} {query} {self.doc_prefix} {doc}"


class BertRerankerInferenceDataset:
    """(qid, pid, query, doc) per pair over an MSMARCO corpus."""

    def __init__(self, qid_pid_pairs: Sequence, query_path: str,
                 corpus_path: str):
        self.qid_pid_pairs = list(qid_pid_pairs)
        self.qid_to_query = read_msmarco_query(query_path)
        self.pid_to_doc = read_msmarco_corpus(corpus_path)

    def __len__(self):
        return len(self.qid_pid_pairs)

    def __getitem__(self, idx):
        qid, pid = self.qid_pid_pairs[idx]
        return (qid, pid, self.qid_to_query[qid],
                get_doc_text(*self.pid_to_doc[pid]))


class BeirDataset:
    """(key, text) over a BEIR corpus ("title text") or query dict."""

    def __init__(self, value_dictionary: dict,
                 information_type: str = "document"):
        if information_type not in ("document", "query"):
            raise ValueError(information_type)
        self.information_type = information_type
        if information_type == "document":
            self.value_dictionary = {
                k: (v["title"] + " " + v["text"])
                for k, v in value_dictionary.items()}
        else:
            self.value_dictionary = dict(value_dictionary)
        self.idx_to_key = {i: k for i, k in enumerate(self.value_dictionary)}

    def __len__(self):
        return len(self.value_dictionary)

    def __getitem__(self, idx):
        key = self.idx_to_key[idx]
        return key, self.value_dictionary[key]


class BeirRerankDataset:
    """(qid, docid, query, "title text") per pair from a local BEIR
    directory (its test split)."""

    def __init__(self, data_path: str, qid_docid_pairs: Sequence):
        corpus, queries, _ = load_beir_dataset(data_path, split="test")
        self.key_to_doc = {k: v["title"] + " " + v["text"]
                           for k, v in corpus.items()}
        self.key_to_query = queries
        self.qid_docid_pairs = list(qid_docid_pairs)

    def __len__(self):
        return len(self.qid_docid_pairs)

    def __getitem__(self, idx):
        qid, docid = self.qid_docid_pairs[idx]
        return qid, docid, self.key_to_query[qid], self.key_to_doc[docid]
