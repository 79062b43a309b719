"""The torch port's ``SparseIndexer`` and the rest of ``SparseIndex``
against the JAX package (CPU, tiny sizes).

A stub model returns fixed dyadic reps with tied values, so both packages
see the same reps and every index array must be bit-equal: through the
top-t packed read, the full read, and the fallback from one to the other;
in ``world_size`` 2 rank builds joined by ``merge_indexes``; through
``from_doc_major``, ``shard_by_rows``, and the h5py layout both ways.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.index import indexer as ref_indexer
from scaling_retriever_tpu.index import inverted_index as ref_inv
from scaling_retriever_tpu_torch.index import indexer, inverted_index

torch.set_num_threads(1)

V = 96


def dyadic_reps(n_docs=40, seed=0):
    """[n_docs, V] reps in {0, 0.25, ..., 2}: 3-12 nonzeros per row, many
    tied within a row; rows 7 and 30 hold 40 nonzeros (over a t of 16)."""
    rng = np.random.default_rng(seed)
    reps = np.zeros((n_docs, V), np.float32)
    for d in range(n_docs):
        nz = 40 if d in (7, 30) else int(rng.integers(3, 13))
        cols = rng.choice(V, nz, replace=False)
        reps[d, cols] = rng.integers(1, 9, nz) / 4.0
    return reps


class StubModel:
    """``encode`` returns the fixed reps of the batch's rows (input_ids
    column 0), as a JAX array or a torch tensor."""

    vocab_size = V

    def __init__(self, reps, framework):
        self.reps = reps
        self.framework = framework

    def encode(self, input_ids, attention_mask):
        out = self.reps[np.asarray(input_ids)[:, 0]]
        return (jnp.asarray(out) if self.framework == "jax"
                else torch.from_numpy(out))


def batches(n_docs, bz=8, rank=0, world_size=1):
    rows = list(range(rank, n_docs, world_size))
    return [{"input_ids": np.array(rows[i:i + bz])[:, None],
             "attention_mask": np.ones((len(rows[i:i + bz]), 1), np.int32),
             "ids": [f"doc{r}" for r in rows[i:i + bz]]}
            for i in range(0, len(rows), bz)]


def assert_same_index(a, b):
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.doc_rows, b.doc_rows)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.offsets.dtype == b.offsets.dtype
    assert a.doc_rows.dtype == b.doc_rows.dtype
    assert a.values.dtype == b.values.dtype
    assert a.doc_ids == b.doc_ids and a.dim == b.dim


def assert_same_files(dir_a, dir_b):
    assert sorted(os.listdir(dir_a)) == sorted(os.listdir(dir_b))
    for f in os.listdir(dir_a):
        if f.endswith(".npz"):
            with np.load(os.path.join(dir_a, f)) as za, \
                    np.load(os.path.join(dir_b, f)) as zb:
                assert za.files == zb.files
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            with open(os.path.join(dir_a, f), "rb") as fa, \
                    open(os.path.join(dir_b, f), "rb") as fb:
                assert fa.read() == fb.read(), f


# (t, batches that overflow t): the packed read, the full read, and the
# packed read with a fallback in the batches holding rows 7 and 30
@pytest.mark.parametrize("t,fallbacks", [(40, 0), (0, 0), (16, 2)])
def test_indexer_files_bit_equal_to_reference(tmp_path, t, fallbacks):
    reps = dyadic_reps()
    out = {}
    for name, mod, fw in (("ref", ref_indexer, "jax"),
                          ("port", indexer, "torch")):
        ix = mod.SparseIndexer(StubModel(reps, fw), str(tmp_path / name),
                               device_sparsify_t=t)
        out[name] = ix.index(batches(len(reps)))
        assert ix.n_fallback_batches == fallbacks
    assert_same_index(out["port"]["index"], out["ref"]["index"])
    assert out["port"]["stats"] == out["ref"]["stats"]
    assert out["port"]["ids_mapping"] == out["ref"]["ids_mapping"]
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "ref"))
    # the index holds every nonzero of the reps
    idx = out["port"]["index"]
    assert idx.nnz == int((reps != 0).sum())
    with open(tmp_path / "port" / "index_stats.json") as f:
        assert json.load(f)["L0_d"] == out["ref"]["stats"]["L0_d"]


def test_tied_values_do_not_change_the_index(tmp_path):
    """Rows of equal values: whatever order ``torch.topk`` returns them
    in, the packed read's postings equal the full read's (each list is
    ordered by row)."""
    reps = np.zeros((6, V), np.float32)
    reps[:, ::7] = 0.5
    reps[2, 3] = 1.0
    a = indexer.SparseIndexer(StubModel(reps, "torch"), None,
                              device_sparsify_t=32).index(batches(6))
    b = indexer.SparseIndexer(StubModel(reps, "torch"), None).index(
        batches(6))
    assert_same_index(a["index"], b["index"])
    for term in range(0, V, 7):
        rows, vals = a["index"].posting(term)
        assert rows.tolist() == list(range(6)) and (vals == 0.5).all()


def test_rank_builds_merge_as_in_reference(tmp_path):
    reps = dyadic_reps(37, seed=1)
    merged = {}
    for name, mod, inv, fw in (("ref", ref_indexer, ref_inv, "jax"),
                               ("port", indexer, inverted_index, "torch")):
        dirs = []
        for rank in range(2):
            d = str(tmp_path / name / f"index_{rank}")
            mod.SparseIndexer(StubModel(reps, fw), d, rank=rank,
                              world_size=2, device_sparsify_t=16).index(
                batches(37, 5, rank, 2))
            dirs.append(d)
        merged[name] = inv.merge_indexes(dirs, str(tmp_path / name / "m"), V)
    assert_same_index(merged["port"], merged["ref"])
    assert_same_files(str(tmp_path / "port" / "m"), str(tmp_path / "ref" / "m"))
    # the interleaved rows put every doc back at its own row
    assert merged["port"].doc_ids == [f"doc{r}" for r in range(37)]
    single = indexer.SparseIndexer(StubModel(reps, "torch"), None).index(
        batches(37))["index"]
    for term in range(V):
        r_m, v_m = merged["port"].posting(term)
        r_s, v_s = single.posting(term)
        order = np.argsort(r_m, kind="stable")
        np.testing.assert_array_equal(r_m[order], r_s)
        np.testing.assert_array_equal(v_m[order], v_s)


def test_doc_major_and_shards_match_reference():
    reps = dyadic_reps(29, seed=2)
    ids = [f"d{i}" for i in range(29)]
    terms = np.argsort(-reps, axis=1, kind="stable")[:, :40].astype(np.int32)
    vals = np.take_along_axis(reps, terms, 1)
    port = inverted_index.SparseIndex.from_doc_major(terms, vals, ids, V)
    ref = ref_inv.SparseIndex.from_doc_major(terms, vals, ids, V)
    assert_same_index(port, ref)
    assert len(port) == len(ref)
    for n_shards, chunk in ((3, 1 << 26), (4, 17)):
        for a, b in zip(port.shard_by_rows(n_shards, chunk),
                        ref.shard_by_rows(n_shards, chunk)):
            assert_same_index(a, b)


def test_h5py_layout_both_ways(tmp_path):
    reps = dyadic_reps(23, seed=3)
    rows, cols = np.nonzero(reps)
    ids = [f"d{i}" for i in range(23)]
    port = inverted_index.SparseIndex.from_triples(rows, cols,
                                                   reps[rows, cols], ids, V)
    port.save_h5py(str(tmp_path / "p"))
    assert_same_index(ref_inv.SparseIndex.load(str(tmp_path / "p")), port)
    ref = ref_inv.SparseIndex.from_triples(rows, cols, reps[rows, cols],
                                           ids, V)
    ref.save_h5py(str(tmp_path / "r"))
    # load() falls back to the h5py layout and the pickled ids
    assert_same_index(inverted_index.SparseIndex.load(str(tmp_path / "r")),
                      ref)
    assert_same_index(inverted_index.SparseIndex.load_h5py(
        str(tmp_path / "r"), dim_voc=V), ref)
    for f in ("index_dist.json", "index_stats.json", "doc_ids.pkl"):
        assert ((tmp_path / "p" / f).read_bytes()
                == (tmp_path / "r" / f).read_bytes()), f
    # a merge's {row: id} pickle, with holes
    import pickle
    with open(tmp_path / "r" / "doc_ids.pkl", "wb") as f:
        pickle.dump({0: "a", 22: "z"}, f)
    got = inverted_index._load_reference_doc_ids(str(tmp_path / "r"))
    assert got == ref_inv._load_reference_doc_ids(str(tmp_path / "r"))
    assert got[0] == "a" and got[22] == "z" and got[5] is None
