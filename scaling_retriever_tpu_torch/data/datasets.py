"""Map-style inference datasets (port of the inference classes of
data/datasets.py): any object with ``__len__``/``__getitem__`` feeds
``data/loader.py``'s DataLoader. The training datasets wait for the
training slice (ROADMAP A11)."""

from __future__ import annotations

from typing import Optional

from scaling_retriever_tpu_torch.data.io import (
    get_doc_text, read_msmarco_corpus, read_msmarco_query, read_wiki_corpus,
)


def _read_corpus(corpus_path: str, data_source: str):
    if data_source == "wiki":
        return read_wiki_corpus(corpus_path)
    if data_source == "msmarco":
        return read_msmarco_corpus(corpus_path)
    raise ValueError("data_source must be either wiki or msmarco")


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
