"""The port's hybrid path and TermEncoderRetriever against the JAX
package's (CPU, tiny widths): ``LlamaBiHybrid``'s two heads and
``rerank_forward``; ``HybridIndexer``'s files (sharded rows, f16 chunks)
equal to the JAX package's and loaded across packages both ways;
``HybridRetriever``'s sparse and dense runs tie-equal to the JAX
package's; ``TermEncoderRetriever``'s runs and scores equal to the JAX
package's; the CUDA default raising on a machine without a card.

Reps from a checkpoint: rtol 1e-4, atol 1e-5 (the frameworks' matmul sum
orders differ). Everything else runs a stand-in encoder whose reps are
dyadic (multiples of 1/8, few bits), so both packages index and score
them exactly: files equal, runs tie-equal at rtol 0."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from helpers import make_tiny_llama_dir  # noqa: E402

from scaling_retriever_tpu.index import hybrid as ref_hybrid  # noqa: E402
from scaling_retriever_tpu.index import inverted_index as ref_ii  # noqa: E402
from scaling_retriever_tpu.index.term_encoder import \
    TermEncoderRetriever as RefTermEncoderRetriever  # noqa: E402
from scaling_retriever_tpu_torch.index import hybrid  # noqa: E402
from scaling_retriever_tpu_torch.index import inverted_index  # noqa: E402
from scaling_retriever_tpu_torch.index.term_encoder import \
    TermEncoderRetriever  # noqa: E402
from scaling_retriever_tpu_torch.utils.utils import \
    tie_equal_topk  # noqa: E402

torch.set_num_threads(1)

VOCAB, DIM = 96, 16


class DyadicHybrid:
    """(sparse [B, VOCAB], dense [B, DIM]) reps from the ids alone, every
    value a multiple of 1/8: torch tensors for the port, numpy for the JAX
    package."""

    vocab_size = VOCAB

    def __init__(self, torch_out: bool):
        self.torch_out = torch_out

    def encode(self, input_ids, attention_mask):
        ids = np.asarray(input_ids) * np.asarray(attention_mask)
        sparse = np.zeros((ids.shape[0], VOCAB), np.float32)
        dense = np.zeros((ids.shape[0], DIM), np.float32)
        for b, row in enumerate(ids):
            for j, t in enumerate(row):
                if t:
                    sparse[b, (t * 7) % VOCAB] += (1 + j % 3) / 8
                    dense[b, t % DIM] += ((t % 5) - 2) / 8
        if self.torch_out:
            return torch.from_numpy(sparse), torch.from_numpy(dense)
        return sparse, dense


def _batches(n, bs, seq, prefix, seed, vocab=250):
    rng = np.random.default_rng(seed)
    out = []
    for start in range(0, n, bs):
        b = min(bs, n - start)
        mask = np.ones((b, seq), np.int32)
        mask[0, :seq // 2] = 0
        out.append({"input_ids": rng.integers(4, vocab, (b, seq)) * mask,
                    "attention_mask": mask,
                    "ids": [f"{prefix}{start + i}" for i in range(b)]})
    return out


def _same_tree(a_dir, b_dir):
    """Every file of two index directories holds the same data."""
    assert sorted(os.listdir(a_dir)) == sorted(os.listdir(b_dir))
    for name in os.listdir(a_dir):
        pa, pb = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if name.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), name
        elif name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (name, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        else:
            xa = np.load(pa, allow_pickle=True)
            xb = np.load(pb, allow_pickle=True)
            assert xa.dtype == xb.dtype, name
            np.testing.assert_array_equal(xa, xb, err_msg=name)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_llama_dir(str(tmp_path_factory.mktemp("hm")), tie=False)


def test_hybrid_encode_matches_reference(model_dir):
    from scaling_retriever_tpu_torch.models.encoder import (LlamaBiDense,
                                                            LlamaBiSparse)

    port = hybrid.LlamaBiHybrid.load(model_dir, device="cpu")
    ref = ref_hybrid.LlamaBiHybrid.load(model_dir)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 256, (3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :4] = 0
    (ps, pd), (rs, rd) = port.encode(ids, mask), ref.encode(ids, mask)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-4,
                               atol=1e-5)
    # one forward, the two single-head encoders' reps
    np.testing.assert_array_equal(
        ps.numpy(), LlamaBiSparse.load(model_dir, device="cpu").encode(
            ids, mask).numpy())
    np.testing.assert_array_equal(
        pd.numpy(), LlamaBiDense.load(model_dir, device="cpu").encode(
            ids, mask).numpy())
    q = {"input_ids": ids, "attention_mask": mask}
    d = {"input_ids": ids[::-1].copy(), "attention_mask": mask[::-1].copy()}
    for alpha in (1.0, 0.25):
        np.testing.assert_allclose(
            port.rerank_forward(q, d, alpha).numpy(),
            np.asarray(ref.rerank_forward(q, d, alpha)), rtol=1e-4,
            atol=1e-5)
    assert hybrid.LlamaBiHybridRetrieverForNCE is hybrid.LlamaBiHybrid
    for name in ("LlamaBiHybrid", "Qwen2BiHybrid"):
        a, b = getattr(hybrid, name), getattr(ref_hybrid, name)
        assert (a.MODEL_TYPE, a.POOLING, a.BASE_MODEL_CLASS) == \
            (b.MODEL_TYPE, b.POOLING, b.BASE_MODEL_CLASS)


@pytest.mark.parametrize("rank,world,fp16", [(0, 1, False), (1, 2, True)])
def test_hybrid_indexer_files_match_reference(tmp_path, rank, world, fp16):
    docs = _batches(40, 8, 10, "d", seed=1)
    out = {}
    for pkg, mod, torch_out in (("port", hybrid, True),
                                ("ref", ref_hybrid, False)):
        sp, de = str(tmp_path / pkg / "sp"), str(tmp_path / pkg / "de")
        mod.HybridIndexer(DyadicHybrid(torch_out), sp, de, chunk_size=100,
                          rank=rank, world_size=world,
                          use_fp16=fp16).index(docs)
        out[pkg] = sp, de
    for a, b in zip(out["port"], out["ref"]):
        _same_tree(a, b)
    assert np.load(os.path.join(out["port"][1], f"embs_{rank}_0.npy")).dtype \
        == (np.float16 if fp16 else np.float32)
    with open(os.path.join(out["port"][1], "plan.json")) as f:
        assert json.load(f) == {"nranks": world, "num_chunks": 5,
                                "index_path": None}
    # each package loads the other's index
    for load, path in ((inverted_index.SparseIndex.load, out["ref"][0]),
                       (ref_ii.SparseIndex.load, out["port"][0])):
        idx = load(path)
        assert idx.nb_docs() == 40 * world
        assert idx.doc_ids[rank] == "d0"


@pytest.fixture(scope="module")
def hybrid_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hyb")
    sp, de = str(root / "sp"), str(root / "de")
    ref_hybrid.HybridIndexer(DyadicHybrid(False), sp, de,
                             chunk_size=64).index(_batches(60, 8, 10, "d", 2))
    return sp, de


def _run_lists(run):
    return {q: sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))
            for q, d in run.items()}


def _tie_equal_runs(got, want):
    assert got.keys() == want.keys()
    g, w = _run_lists(got), _run_lists(want)
    for q in w:
        tie_equal_topk([d for d, _ in w[q]], [s for _, s in w[q]],
                       [d for d, _ in g[q]], [s for _, s in g[q]], rtol=0.0)


@pytest.mark.parametrize("engine", ["xla", "segsort"])
def test_hybrid_retriever_runs_match_reference(hybrid_dirs, tmp_path,
                                               engine):
    sp, de = hybrid_dirs
    qs = _batches(10, 4, 6, "q", seed=3)
    want = ref_hybrid.HybridRetriever(
        DyadicHybrid(False), sp, de, str(tmp_path / "ref"),
        topk=7).retrieve(qs)
    got = hybrid.HybridRetriever(
        DyadicHybrid(True), sp, de, str(tmp_path / "port"), topk=7,
        engine=engine, device="cpu").retrieve(qs)
    for head in ("sparse", "dense"):
        _tie_equal_runs(got[head], want[head])
        with open(tmp_path / "port" / head / "run.json") as f:
            assert json.load(f) == got[head]
    assert len(got["dense"]) == 10 and all(
        len(v) == 7 for v in got["dense"].values())


class Lex:
    """``lex_encode``: a term count per query over a 128-term vocabulary."""

    def lex_encode(self, input_ids, attention_mask):
        ids = np.asarray(input_ids)
        reps = np.zeros((ids.shape[0], 128), np.float32)
        for b in range(ids.shape[0]):
            for t in ids[b]:
                reps[b, t % 128] += 1.0
        return reps


class HybridOnly(DyadicHybrid):
    """A hybrid model without ``lex_encode``: its sparse head is used."""


@pytest.mark.parametrize("code_len", [16, 32])
@pytest.mark.parametrize("model", ["lex", "hybrid"])
def test_term_encoder_matches_reference(tmp_path, code_len, model):
    rng = np.random.default_rng(code_len)
    vocab = 128 if model == "lex" else VOCAB
    codes = {f"d{i}": rng.integers(0, vocab, code_len).tolist()
             for i in range(50)}
    batches = [{"input_ids": rng.integers(1, 250, (4, 6)),
                "attention_mask": np.ones((4, 6), np.int32),
                "queries": [f"q{i + 4 * j}" for i in range(4)]}
               for j in range(2)]
    mk = {"lex": lambda t: Lex(), "hybrid": HybridOnly}[model]
    got = TermEncoderRetriever(mk(True), block=8, device="cpu").retrieve(
        batches, codes, topk=7, out_dir=str(tmp_path / "port"))
    want = RefTermEncoderRetriever(mk(False), block=8).retrieve(
        batches, codes, topk=7, out_dir=str(tmp_path / "ref"))
    _tie_equal_runs(got, want)
    assert len(got) == 8 and all(len(v) == 7 for v in got.values())
    with open(tmp_path / "port" / "run.json") as f:
        assert json.load(f) == got
    # scores: pred[:, codes].sum(-1), by hand and in the JAX package
    enc = np.asarray(list(codes.values()))
    preds = np.asarray(mk(False).lex_encode(batches[0]["input_ids"], None)
                       if model == "lex" else
                       mk(False).encode(batches[0]["input_ids"],
                                        batches[0]["attention_mask"])[0])
    scores = TermEncoderRetriever(None, block=8, device="cpu").get_doc_scores(
        preds, enc)
    np.testing.assert_array_equal(scores, preds[:, enc].sum(-1))
    np.testing.assert_array_equal(
        scores, RefTermEncoderRetriever(None, block=8).get_doc_scores(
            preds, enc))
    with pytest.raises(ValueError, match="length"):
        TermEncoderRetriever(Lex(), block=8, device="cpu").retrieve(
            batches, {"d": [1, 2, 3]}, topk=3, out_dir=str(tmp_path / "x"))


def test_cuda_default_raises_without_a_card(hybrid_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default runs")
    sp, de = hybrid_dirs
    with pytest.raises((RuntimeError, AssertionError)):
        hybrid.HybridRetriever(DyadicHybrid(True), sp, de, str(tmp_path))
    with pytest.raises((RuntimeError, AssertionError)):
        TermEncoderRetriever(Lex()).retrieve(
            _batches(2, 2, 4, "q", 0), {"d0": list(range(16))}, 1,
            str(tmp_path))
