"""Corpus and query readers and the document text format (port of
data/io.py): MSMARCO/wiki TSV readers, ``"title: {t} | context: {x}"``,
and a BEIR-format reader (corpus.jsonl, queries.jsonl, qrels/<split>.tsv)
for datasets already on disk."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional, Tuple


def read_wiki_corpus(corpus_path: str) -> Dict[str, Tuple[Optional[str], str]]:
    pid_to_doc = {}
    with open(corpus_path) as fin:
        for i, line in enumerate(fin):
            if i == 0:
                continue  # header row
            pid, text, title = line.rstrip("\n").split("\t")
            pid_to_doc[pid] = (title, text)
    return pid_to_doc


def read_msmarco_corpus(corpus_path: str
                        ) -> Dict[str, Tuple[Optional[str], str]]:
    pid_to_doc = {}
    with open(corpus_path) as fin:
        for line in fin:
            pid, text = line.rstrip("\n").split("\t")
            pid_to_doc[pid] = (None, text)
    return pid_to_doc


def read_msmarco_query(query_path: str) -> Dict[str, str]:
    qid_to_query = {}
    with open(query_path) as fin:
        for line in fin:
            qid, query = line.rstrip("\n").split("\t")
            qid_to_query[qid] = query
    return qid_to_query


def get_doc_text(title: Optional[str], text: str) -> str:
    if title is None:
        return text
    return f"title: {title} | context: {text}"


def load_beir_dataset(data_dir: str, split: str = "test"
                      ) -> tuple[dict, dict, dict]:
    """(corpus, queries, qrels) of a BEIR-format directory: corpus
    {doc_id: {"title", "text"}}, queries {qid: text} (only queries with
    qrels), qrels {qid: {doc_id: relevance}}."""
    corpus = {}
    with open(os.path.join(data_dir, "corpus.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            corpus[str(row["_id"])] = {"title": row.get("title", "") or "",
                                       "text": row.get("text", "") or ""}
    queries = {}
    with open(os.path.join(data_dir, "queries.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            queries[str(row["_id"])] = row["text"]

    qrels: dict = {}
    with open(os.path.join(data_dir, "qrels", f"{split}.tsv")) as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader)   # header
        for row in reader:
            qid, did, score = row[0], row[1], int(row[2])
            qrels.setdefault(str(qid), {})[str(did)] = score
    queries = {qid: q for qid, q in queries.items() if qid in qrels}
    return corpus, queries, qrels
