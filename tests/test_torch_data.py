"""The port's data layer (constants.py, data/io.py, data/datasets.py,
data/loader.py, data/collators.py) against the JAX package's on the same
tiny files: equal items, batches and token arrays."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_tiny_tokenizer  # noqa: E402

from scaling_retriever_tpu import constants as ref_constants  # noqa: E402
from scaling_retriever_tpu.data import collators as ref_collators  # noqa: E402
from scaling_retriever_tpu.data import datasets as ref_datasets  # noqa: E402
from scaling_retriever_tpu.data import io as ref_io  # noqa: E402
from scaling_retriever_tpu.data import loader as ref_loader  # noqa: E402
from scaling_retriever_tpu_torch import constants  # noqa: E402
from scaling_retriever_tpu_torch.data import (  # noqa: E402
    collators, datasets, io, loader,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    with open(root / "msmarco.tsv", "w") as f:
        for d in range(11):
            f.write(f"d{d}\tw{d} w{d + 1} w{d + 2}\n")
    with open(root / "wiki.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        for d in range(7):
            f.write(f"p{d}\tw{d} w{2 * d}\tt{d}\n")
    with open(root / "queries.tsv", "w") as f:
        for q in range(5):
            f.write(f"q{q}\tw{q} w{q + 3}\n")
    beir = root / "beir"
    os.makedirs(beir / "qrels")
    with open(beir / "corpus.jsonl", "w") as f:
        for d in range(6):
            f.write(json.dumps({"_id": f"b{d}", "title": f"t{d}" if d % 2
                                else None, "text": f"w{d} w{d + 4}"}) + "\n")
    with open(beir / "queries.jsonl", "w") as f:
        for q in range(4):
            f.write(json.dumps({"_id": q, "text": f"w{q}"}) + "\n")
    with open(beir / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q in range(3):
            f.write(f"{q}\tb{q}\t1\n{q}\tb{q + 2}\t2\n")
    return root


@pytest.mark.parametrize("source", ["msmarco", "wiki"])
def test_datasets_and_readers_equal(files, source):
    path = str(files / f"{source}.tsv")
    mine = datasets.CollectionDataset(path, source)
    theirs = ref_datasets.CollectionDataset(path, source)
    assert [mine[i] for i in range(len(mine))] == \
        [theirs[i] for i in range(len(theirs))] and len(mine) > 0
    q = str(files / "queries.tsv")
    for mod, ref in ((datasets.MSMARCOQueryDataset,
                      ref_datasets.MSMARCOQueryDataset),
                     (datasets.WikiQueryDataset,
                      ref_datasets.WikiQueryDataset)):
        a, b = mod(q), ref(q)
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    assert io.read_msmarco_query(q) == ref_io.read_msmarco_query(q)
    corpus, queries, qrels = io.load_beir_dataset(str(files / "beir"))
    assert (corpus, queries, qrels) == ref_io.load_beir_dataset(
        str(files / "beir"))
    for kind, values in (("document", corpus), ("query", queries)):
        a = datasets.BeirDataset(values, kind)
        b = ref_datasets.BeirDataset(values, kind)
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    for path in ("/data/msmarco/corpus.tsv", "/x/NQ/psgs.tsv", "/x/wiki",
                 "", "/x/other"):
        assert constants.guess_data_source(path) == \
            ref_constants.guess_data_source(path)


@pytest.mark.parametrize("shuffle,world,strided,drop", [
    (False, 1, True, False), (True, 1, True, True), (False, 3, True, False),
    (True, 2, False, False), (False, 4, False, True)])
def test_loader_batches_equal(shuffle, world, strided, drop):
    data = list(range(23))
    for rank in range(world):
        kw = dict(shuffle=shuffle, seed=5, drop_last=drop, rank=rank,
                  world_size=world, strided_shard=strided)
        a = loader.DataLoader(data, 4, list, **kw)
        b = ref_loader.DataLoader(data, 4, list, **kw)
        a.set_epoch(2)
        b.set_epoch(2)
        assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("fixed_length", [False, True])
def test_collection_collator_equal(files, tmp_path_factory, fixed_length):
    tok = make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    ds = datasets.CollectionDataset(str(files / "msmarco.tsv"), "msmarco")
    batch = [ds[i] for i in range(5)]
    a = collators.LlamaSparseCollectionCollator(
        tok, 8, fixed_length=fixed_length)(batch)
    b = ref_collators.LlamaSparseCollectionCollator(
        tok, 8, fixed_length=fixed_length)(batch)
    assert a.keys() == b.keys() and a["ids"] == b["ids"]
    for k in ("input_ids", "attention_mask"):
        assert a[k].dtype == np.int32 and np.array_equal(a[k], b[k])
    assert collators.T5SparseCollectionCollator is \
        collators.LlamaSparseCollectionCollator


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_batch(a[k], b[k])
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kind", ["hybrid_msmarco", "hybrid_wiki", "cross",
                                  "bert", "beir"])
def test_rerank_datasets_and_collators_equal(files, tmp_path_factory, kind):
    """The rerank half: each dataset's items and its collator's batch equal
    the JAX package's (token arrays bit-equal)."""
    tok = make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    q = str(files / "queries.tsv")
    if kind.startswith("hybrid"):
        source = kind.split("_")[1]
        pids = ["d1", "d4", "d9"] if source == "msmarco" else ["p0", "p6"]
        pairs = [(f"q{i}", p) for i in range(3) for p in pids]
        args = (pairs, q, str(files / f"{source}.tsv"))
        kw = {"data_source": source}
        names = ("HybridRetrieverRerankDataset",
                 "HybridRetrieverRerankCollator", (tok, 8, 16))
    elif kind == "cross":
        pairs = [(f"q{i}", f"d{2 * i}") for i in range(5)]
        args = (pairs, q, str(files / "msmarco.tsv"))
        kw = {"query_prefix": "query:", "doc_prefix": "document:"}
        names = ("RerankerInferenceDataset", "RerankerInferenceCollator",
                 (tok, 32))
    elif kind == "bert":
        pairs = [(f"q{i}", f"d{i + 3}") for i in range(4)]
        args = (pairs, q, str(files / "msmarco.tsv"))
        kw = {}
        names = ("BertRerankerInferenceDataset",
                 "BertRerankerInferenceCollator", (tok, 10))
    else:
        pairs = [("0", "b1"), ("2", "b5"), ("1", "b0")]
        args = (str(files / "beir"), pairs)
        kw = {}
        names = ("BeirRerankDataset", "BertRerankerInferenceCollator",
                 (tok, 10))
    ds_name, coll_name, coll_args = names
    mine = getattr(datasets, ds_name)(*args, **kw)
    theirs = getattr(ref_datasets, ds_name)(*args, **kw)
    assert _items(mine) == _items(theirs) and len(mine) == len(pairs)
    _same_batch(getattr(collators, coll_name)(*coll_args)(_items(mine)),
                getattr(ref_collators, coll_name)(*coll_args)(_items(theirs)))
    if kind == "cross":
        with pytest.raises(ValueError, match="prefix"):
            datasets.RerankerInferenceDataset(*args)
    if kind == "hybrid_msmarco":
        with pytest.raises(ValueError):
            datasets.HybridRetrieverRerankDataset(*args, data_source=None)


def test_t5_training_collators_are_the_llama_layouts():
    assert collators.T5SparseCollatorForNCE is \
        collators.LlamaSparseCollatorForNCE
    assert collators.T5SparseCollatorForMarginMSE is \
        collators.LlamaSparseCollatorForMarginMSE
    assert collators.LlamaHybridCollectionCollator is \
        collators.LlamaSparseCollectionCollator
