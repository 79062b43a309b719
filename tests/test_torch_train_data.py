"""The port's training datasets and collators against the JAX package's on
the same files, seeds and tokenizer: every batch identical (token ids,
masks, target_labels, teacher_idxes and teacher scores), since both draw
negatives with Python's ``random.Random(seed)``."""

import json
import os
import sys

import numpy as np
import pytest

from scaling_retriever_tpu.data import collators as ref_C
from scaling_retriever_tpu.data import datasets as ref_D
from scaling_retriever_tpu.data.loader import DataLoader as RefLoader
from scaling_retriever_tpu_torch.data import collators as C
from scaling_retriever_tpu_torch.data import datasets as D
from scaling_retriever_tpu_torch.data.loader import DataLoader

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_msmarco_style_data, make_tiny_tokenizer  # noqa: E402

LOSSES = {
    "nce": ("DualEncoderDatasetForNCE", "LlamaSparseCollatorForNCE"),
    "margin_mse": ("DualEncoderDatasetForMarginMSE",
                   "LlamaSparseCollatorForMarginMSE"),
    "kldiv": ("DualEncoderDatasetForKLDiv", "LlamaSparseCollatorForKLDiv"),
    "nce_kldiv": ("DualEncoderDatasetForKLDiv",
                  "LlamaSparseCollatorForNCE_KLDiv"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    corpus, queries, _ = make_msmarco_style_data(root, n_docs=40,
                                                 n_queries=12)
    with open(corpus) as f:
        pids = [line.split("\t")[0] for line in f]
    with open(queries) as f:
        qs = [line.rstrip("\n").split("\t")[1] for line in f]
    rng = np.random.default_rng(1)
    paths = {}
    for kind in ("nce", "kldiv", "margin_mse"):
        paths[kind] = os.path.join(root, f"{kind}.jsonl")
        with open(paths[kind], "w") as f:
            for i, q in enumerate(qs):
                negs = [str(p) for p in rng.choice(pids[12:], 6,
                                                   replace=False)]
                if kind == "margin_mse":
                    ex = {"query": q, "docids": [f"doc{i}"] + negs,
                          "scores": rng.standard_normal(7).round(3).tolist()}
                else:
                    ex = {"question": q, "pos_pid": f"doc{i}",
                          "neg_pids": negs}
                    if kind == "kldiv":
                        ex["pos_score"] = float(rng.standard_normal())
                        ex["neg_scores"] = rng.standard_normal(6).tolist()
                f.write(json.dumps(ex) + "\n")
    tok = make_tiny_tokenizer(os.path.join(root, "tok"))
    return corpus, paths, tok


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    else:
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("loss", list(LOSSES))
@pytest.mark.parametrize("fixed_length", [False, True])
def test_batches_match_reference(files, loss, fixed_length):
    corpus, paths, tok = files
    ds_name, coll_name = LOSSES[loss]
    train = paths["kldiv" if "kldiv" in loss else loss]
    kw = {} if loss == "margin_mse" else {"n_negs": 3}

    def batches(D_, C_, Loader):
        ds = getattr(D_, ds_name)(corpus, train, "msmarco", seed=7, **kw)
        coll = getattr(C_, coll_name)(tok, 16, 24, fixed_length=fixed_length)
        loader = Loader(ds, 4, coll, shuffle=True, seed=7, drop_last=True)
        out = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            out.extend(loader)
        return out

    got = batches(D, C, DataLoader)
    want = batches(ref_D, ref_C, RefLoader)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _same(g, w)
    if loss == "nce_kldiv":
        b = got[0]
        assert b["teacher_idxes"].shape == (4, 4)
        np.testing.assert_array_equal(b["teacher_idxes"][1], [1, 7, 8, 9])


def test_dense_collators_are_the_sparse_ones():
    for name in ("NCE", "KLDiv", "NCE_KLDiv", "MarginMSE"):
        assert (getattr(C, f"LlamaDenseCollatorFor{name}")
                is getattr(C, f"LlamaSparseCollatorFor{name}"))


def test_kldiv_checks_its_input(files):
    corpus, paths, _ = files
    with pytest.raises(ValueError, match="msmarco"):
        D.DualEncoderDatasetForKLDiv(corpus, paths["kldiv"], "wiki")
