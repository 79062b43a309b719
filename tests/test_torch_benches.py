"""The port's benchmark drivers (scaling_retriever_tpu_torch/benches) on the
CPU at tiny sizes: each driver's ``main([... "--device", "cpu"])`` prints
one JSON line last with its arms, the card ("cpu") and ``correct`` true,
and asked for "cuda" without a card it raises. The generators are held
bit-equal to the JAX benches': the uniform rows to bench.py's hash, the
power-law band tables, CSR, prefix, doc-major rows, calibration and
queries to bench_zipf.py's (its constants patched small), the host
lane to bench_serving_zipf.py's, and the clustered corpus, its tiles and
its block-max meta to bench_bmx.py's at both of its small
configurations. The layout ladder's job bounds are bench_bf16.py's, and
the indexing driver's sparsified encoder gives bench_indexing.py's reps
on the same weights (f32, tiny widths: the same top-L0 sets, values
within rtol 1e-5). The training drivers are in
test_torch_benches_train.py."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_bmx  # noqa: E402
import bench_indexing  # noqa: E402
import bench_serving_zipf  # noqa: E402
import bench_zipf  # noqa: E402
from scaling_retriever_tpu.models import llama as ref_llama  # noqa: E402
from scaling_retriever_tpu.models.config import (  # noqa: E402
    ModelConfig as RefModelConfig)
from scaling_retriever_tpu.models.encoder import (  # noqa: E402
    LlamaBiSparse as RefLlamaBiSparse)
from scaling_retriever_tpu.ops.blockmax import (  # noqa: E402
    build_chunk_meta as ref_build_chunk_meta)
from scaling_retriever_tpu_torch.benches import (  # noqa: E402
    bf16, bmx, common, corpora, dense, indexing, mntp, serving,
    serving_dense, serving_zipf, text, train, uniform, zipf,
)
from scaling_retriever_tpu_torch.models.config import ModelConfig  # noqa: E402
from scaling_retriever_tpu_torch.models.encoder import (  # noqa: E402
    LlamaBiSparse)
from scaling_retriever_tpu_torch.models.weights import (  # noqa: E402
    params_from_jax)
from scaling_retriever_tpu_torch.ops.blockmax import (  # noqa: E402
    build_chunk_meta)
from scaling_retriever_tpu_torch.ops.fetch import CHUNK, CHUNK2  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
# a small power-law index: 126 terms, lists of 3,000 down to 114 postings
# (39,784), N prime so the affine doc map is a bijection; a 512-deep prefix
# cuts the two longest bands, so calibrated tiles certify and hot ones fall
# back
ZIPF = corpora.ZipfSpec(n_docs=10007, w0=2, bands=6, l0=3000, rho=0.52,
                        prefix=512)
DRIVERS = (uniform, serving, zipf, serving_zipf, text, dense, serving_dense,
           bf16, bmx, indexing, train, mntp)
LADDER = (("CONCURRENCY", (1, 4)), ("SECONDS", 0.5))   # two short rungs
# bench_bmx.py's two small configurations (its --small mode): everything
# gated at the first, pruning engaged at the second
BMX_SMALL = (dict(C=8, S=1280, PT=4, L_IN=768, L_BG=256, V_G=16, L_G=2048,
                  n_topic_q=3, n_generic_q=4),
             dict(C=32, S=2560, PT=8, L_IN=2048, L_BG=1024, V_G=64,
                  L_G=8192, n_topic_q=4, n_generic_q=4))


@pytest.fixture
def bench_zipf_small(monkeypatch):
    """bench_zipf.py's (and bench_serving_zipf.py's) constants set to
    ZIPF's."""
    for mod in (bench_zipf, bench_serving_zipf):
        monkeypatch.setattr(mod, "N_DOCS", ZIPF.n_docs)
        monkeypatch.setattr(mod, "A_MULT", ZIPF.a_mult)
        monkeypatch.setattr(mod, "GAMMA", ZIPF.gamma)
    for name, v in (("W0", ZIPF.w0), ("B_BANDS", ZIPF.bands),
                    ("L0", ZIPF.l0), ("RHO", ZIPF.rho),
                    ("F_PREFIX", ZIPF.prefix)):
        monkeypatch.setattr(bench_zipf, name, v)
    return bench_zipf


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def run_driver(mod, capsys) -> dict:
    rc = mod.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, line
    for key in ("metric", "value", "unit", "card", "correct", "arms"):
        assert key in line, key
    assert line["correct"] is True and line["card"] == "cpu"
    assert np.isfinite(line["value"]) and line["value"] > 0
    return line


# ---- generators against the JAX benches ---------------------------------


def test_uniform_rows_equal_bench_hash():
    """bench.py:89-93's rows (uint32 hash, folded once into [0, N_DOCS):
    MSMARCO's doc count, > 2^23; one posting a doc over 8,192 terms)."""
    n_docs, k, vocab = 8_841_823, 1, 8192
    rows, offsets, nnz = corpora.uniform_rows(CPU, n_docs, k, vocab)

    @jax.jit
    def gen_rows():
        i = jax.lax.broadcasted_iota(jnp.uint32, (nnz, 1), 0)[:, 0]
        h = (i * jnp.uint32(2654435761)) ^ ((i * jnp.uint32(2654435761))
                                            >> 13)
        r = (h & jnp.uint32((1 << 24) - 1)).astype(jnp.int32)
        return jnp.where(r >= n_docs, r - n_docs, r)

    np.testing.assert_array_equal(rows[:nnz].numpy(), np.asarray(gen_rows()))
    assert (rows[nnz:] == n_docs).all()
    np.testing.assert_array_equal(
        offsets, np.arange(vocab + 1) * ((n_docs * k) // vocab))
    packed = corpora.q8_words(rows, nnz, n_docs)
    np.testing.assert_array_equal(
        packed[:nnz].numpy().view(np.uint32),
        (rows[:nnz].numpy().astype(np.uint32) << 8) | 255)


def test_zipf_index_equals_bench_zipf(bench_zipf_small):
    bz = bench_zipf_small
    tj = bz.build_band_tables()
    corpus = corpora.ZipfCorpus(ZIPF, CPU)
    assert tj.keys() == corpus.t.keys()
    for key, want in tj.items():
        np.testing.assert_array_equal(_bits(corpus.t[key]), _bits(want),
                                      err_msg=key)
    t_full = dict(tj, pre_L=tj["L"], pre_lens=tj["lens"],
                  pre_offsets=tj["offsets"], pre_post_start=tj["post_start"],
                  pre_nnz=tj["nnz"])
    with bz.enable_x64():
        want = {"full": bz.gen_prefix_csr(t_full),
                "prefix": bz.gen_prefix_csr(tj),
                "doc_major": bz.gen_doc_major(tj)}
        want = {k: [np.asarray(a) for a in v[:2]] for k, v in want.items()}
    for name, prefix, n in (("full", False, tj["nnz"]),
                            ("prefix", True, tj["pre_nnz"])):
        rows, bits = corpus.csr(prefix=prefix, blk=4096)
        np.testing.assert_array_equal(rows.numpy(), want[name][0][:n + 1024])
        np.testing.assert_array_equal(bits.numpy(), want[name][1][:n + 1024])
    terms, vals, K = corpus.doc_major(dblk=4096)
    assert K == -(-tj["nnz"] // ZIPF.n_docs)
    np.testing.assert_array_equal(terms.numpy(),
                                  want["doc_major"][0][:len(terms)])
    np.testing.assert_array_equal(_bits(vals.numpy()),
                                  _bits(want["doc_major"][1][:len(vals)]))
    assert not want["doc_major"][0][len(terms):].any()


def test_zipf_queries_equal_bench_zipf(bench_zipf_small):
    bz = bench_zipf_small
    t = corpora.band_tables(ZIPF)
    alpha = corpora.calibrate_alpha(t, 20_000.0, bz.L0_Q)
    assert alpha == bz.calibrate_alpha(t, 20_000.0)
    got = corpora.make_queries(t, np.random.default_rng(3), 2, alpha,
                               bz.TILE, bz.T_BUDGET, bz.L0_Q)
    want = bz.make_queries(t, np.random.default_rng(3), 2, alpha)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert (corpora.jobs_for(got, t["pre_offsets"], t["pre_lens"])
            == bz.jobs_for(want, t["pre_offsets"], t["pre_lens"]))


def test_zipf_host_lane_equals_bench_serving_zipf(bench_zipf_small):
    t = corpora.band_tables(ZIPF)
    ours = corpora.ZipfHostLane(t, ZIPF)
    ref = bench_serving_zipf.ZipfHostLane(t)
    rng = np.random.default_rng(5)
    for alpha in (0.0, 0.7):
        for terms, vals in corpora.query_pool(t, rng, alpha, 3, 24):
            vals[0] = 0.0               # an unused slot
            a_rows, a_scores = ours.retrieve_sparse(terms, vals, 100)
            b_rows, b_scores = ref.retrieve_sparse(terms, vals, 100)
            np.testing.assert_array_equal(a_rows, b_rows)
            np.testing.assert_array_equal(_bits(a_scores), _bits(b_scores))


# ---- the drivers on the CPU ---------------------------------------------


@pytest.mark.parametrize("mod", DRIVERS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_without_card_raises(mod):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _uniform_small(monkeypatch, mod):
    for name, v in (("N_DOCS", 20_000), ("K", 16), ("VOCAB", 2048),
                    ("TOPK", 100)):
        monkeypatch.setattr(mod, name, v)


def test_uniform_rehearsal(monkeypatch, capsys):
    _uniform_small(monkeypatch, uniform)
    for name, v in (("TILE", 8), ("JOBS_PER_QUERY", 128), ("N_TILES", 3),
                    ("N_PASSES", 2)):
        monkeypatch.setattr(uniform, name, v)
    line = run_driver(uniform, capsys)
    assert set(line["arms"]) == {"f32", "q8"}
    assert line["vs_baseline"] > 0 and line["baseline"]["qps"] > 0


def test_serving_rehearsal(monkeypatch, capsys):
    _uniform_small(monkeypatch, serving)
    for name, v in (("WIDTHS", (2, 8)), ("POOL", 64)) + LADDER:
        monkeypatch.setattr(serving, name, v)
    line = run_driver(serving, capsys)
    assert set(line["arms"]) == {"f32", "q8"}
    for arm in line["arms"].values():
        for rung in arm["by_concurrency"].values():
            for key in ("qps", "p50_ms", "p95_ms", "p99_ms", "mean_batch",
                        "n_cost_splits", "n_hot", "n_hot_shed"):
                assert key in rung, key
            assert rung["n"] > 0


def _zipf_small(monkeypatch, mod):
    monkeypatch.setattr(mod, "SPEC", ZIPF)
    for name, v in (("TOPK", 100), ("T_BUDGET", 16), ("L0_Q", 16),
                    ("TARGET_MATCHED", 8_000.0)):
        monkeypatch.setattr(mod, name, v)


def test_zipf_rehearsal(monkeypatch, capsys):
    _zipf_small(monkeypatch, zipf)
    for name, v in (("C_CAND", 256), ("TILE", 8), ("N_TILES", 2),
                    ("S_SLOTS", 2048), ("DOC_BLOCK", 1024)):
        monkeypatch.setattr(zipf, name, v)
    line = run_driver(zipf, capsys)
    arms = line["arms"]
    assert set(arms) == {"segsort_full", "maxscore", "maxscore_hot"}
    # both the certified path and the doc-major fallback ran
    assert arms["maxscore"]["certified"] > 0
    assert arms["maxscore_hot"]["fallback_tiles"] > 0
    assert line["baseline"]["qps"] > 0


def test_serving_zipf_rehearsal(monkeypatch, capsys):
    _zipf_small(monkeypatch, serving_zipf)
    for name, v in (("WIDTHS", (2, 4, 8)), ("POOL", 64), ("HOT_POOL", 16),
                    ("TILE_SLOTS_CAP", 256), ("WARM_PASSES", 1),
                    ("HOT_EVERY", 4), ("CONCURRENCY", (2, 8)),
                    ("SECONDS", 0.5)):
        monkeypatch.setattr(serving_zipf, name, v)
    # the fast-lane cap sits below the hot pool's third-largest need, so
    # at least CHECK_HOT hot-pool queries take the host lane
    t = corpora.band_tables(ZIPF)
    _, hot, _ = serving_zipf.pools(t, 0)
    need = sorted(int(corpora.job_need(q[0][None], q[1][None], t["offsets"],
                                       t["lens"])[0]) for q in hot)
    monkeypatch.setattr(serving_zipf, "MAX_NEED_JOBS", need[-3])
    line = run_driver(serving_zipf, capsys)
    rungs = line["arms"]["f32"]["by_concurrency"]
    assert sum(r["n_cost_splits"] for r in rungs.values()) > 0
    assert sum(r["n_hot"] for r in rungs.values()) > 0
    assert line["traffic"]["hot_pool_routed_hot"] >= 2


def test_text_rehearsal(monkeypatch, capsys):
    _uniform_small(monkeypatch, text)
    for name, v in (("VOCAB", 512), ("TOPK", 50), ("WIDTHS", (2, 8)),
                    ("T_SPARSE", 16), ("Q_WORDS", 4),
                    ("LENGTH_RUNGS", (8, 16)), ("WORD_BANK", 256),
                    ("POOL", 64), ("SAMPLE", 4), *LADDER,
                    ("MODEL", {"num_hidden_layers": 2, "hidden_size": 64,
                               "intermediate_size": 128,
                               "num_attention_heads": 4,
                               "num_key_value_heads": 2, "head_dim": 16})):
        monkeypatch.setattr(text, name, v)
    line = run_driver(text, capsys)
    assert set(line["arms"]) == {"f32", "q8"}
    assert "2 layers x 64" in line["unit"]


def _dense_small(monkeypatch, mod):
    for name, v in (("N_DOCS", 5000), ("D", 64), ("CHUNK", 1024),
                    ("TOPK", 50)):
        monkeypatch.setattr(mod, name, v)


def test_dense_rehearsal(monkeypatch, capsys):
    _dense_small(monkeypatch, dense)
    for name, v in (("BLOCK", 128), ("TILE", 16), ("N_TILES", 2),
                    ("CPU_SLICE", 2000), ("CPU_Q", 8), ("ORACLE_Q", 4)):
        monkeypatch.setattr(dense, name, v)
    line = run_driver(dense, capsys)
    assert set(line["arms"]) == {"bf16", "int8"}
    assert line["arms"]["bf16"]["certified"] == 1.0
    assert line["vs_baseline"] > 0


def test_serving_dense_rehearsal(monkeypatch, capsys):
    _dense_small(monkeypatch, serving_dense)
    for name, v in (("SEL_BLOCK", 128), ("WIDTHS", (2, 8)),
                    ("POOL", 64)) + LADDER:
        monkeypatch.setattr(serving_dense, name, v)
    line = run_driver(serving_dense, capsys)
    assert set(line["arms"]) == {"bf16", "int8"}


def test_closed_loop_counts_and_sheds():
    """The ladder's counters: every request is served or shed, and the
    per-rung numbers come from that rung alone."""
    calls = {"n": 0}

    class Overloaded(Exception):
        pass

    def call(req):
        calls["n"] += 1
        if req % 3 == 0:
            raise Overloaded
        return req

    res, kept = common.closed_loop(call, lambda rng, j: j, (1, 3), 0.2,
                                   shed=(Overloaded,), keep=2)
    total = sum(r["n"] + r["n_shed"] for r in res.values())
    assert total == calls["n"] and res[3]["n_shed"] > 0
    assert all(len(k) == 2 and k[0][0] % 3 for k in kept.values())


# ---- the layout ladder (benches/bf16.py) ----------------------------------


def _bench_bf16_need(tiles, host_offsets, chunk):
    """bench_bf16.py's ``need(chunk)`` (a closure of its ``main``),
    verbatim."""
    mx = 0
    for qt, qv in tiles:
        qt_h, qv_h = np.asarray(qt), np.asarray(qv)
        starts = host_offsets[qt_h]
        lens = (np.diff(host_offsets)[qt_h] * (qv_h > 0))
        heads = starts % chunk
        mx = max(mx, int(np.sum(-(-(heads + lens) // chunk) * (lens > 0),
                                axis=1).max()))
    return mx


def _bench_bf16_tiles(seed, n):
    """bench_bf16.py's query tiles (inline in its ``main``)."""
    rng = np.random.default_rng(seed)
    tiles = []
    for _ in range(n):
        qt = rng.integers(0, 128_256, (64, 64)).astype(np.int32)
        qv = rng.uniform(0.1, 2.0, (64, 64)).astype(np.float32)
        qv[:, 48:] = 0.0
        tiles.append((qt, qv))
    return tiles


def test_bf16_job_bounds_equal_bench_bf16():
    """At the published sizes (host offsets only): bench_bf16.py's 13
    tiles, and each layout's job bound, with the slab rounded up by fewer
    than one B5 block of jobs."""
    per_term = (uniform.N_DOCS * uniform.K) // uniform.VOCAB
    offsets = np.arange(uniform.VOCAB + 1, dtype=np.int64) * per_term
    tiles = uniform.query_tiles(np.random.default_rng(0), uniform.N_TILES + 1)
    for (a, b), (c, d) in zip(tiles, _bench_bf16_tiles(0, 13)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for chunk in (CHUNK, CHUNK2):
        jobs = bf16.need(tiles, offsets, chunk)
        assert jobs == _bench_bf16_need(tiles, offsets, chunk)
        slab = bf16.slab_jobs(jobs, chunk)
        per = bf16.SEL_BLOCK // chunk
        assert slab % per == 0 and jobs <= slab < jobs + per


def test_bf16_rehearsal(monkeypatch, capsys):
    _uniform_small(monkeypatch, uniform)
    for name, v in (("TILE", 8), ("N_TILES", 3), ("N_PASSES", 2)):
        monkeypatch.setattr(uniform, name, v)
    line = run_driver(bf16, capsys)
    arms = line["arms"]
    assert set(arms) == {"f32", "bf16", "q8"}
    assert line["value"] == arms["q8"]["qps"] and line["vs_baseline"] > 0
    assert line["rows_identical_bf16"] > 0.5
    assert line["rows_identical_q8"] > 0.5
    per_term = (uniform.N_DOCS * uniform.K) // uniform.VOCAB
    offsets = np.arange(uniform.VOCAB + 1, dtype=np.int64) * per_term
    tiles = uniform.query_tiles(np.random.default_rng(0), uniform.N_TILES + 1)
    for name, chunk in (("f32", CHUNK), ("bf16", CHUNK2), ("q8", CHUNK)):
        assert arms[name]["jobs"] == _bench_bf16_need(tiles, offsets, chunk)


# ---- the clustered corpus (benches/bmx.py) --------------------------------


@pytest.mark.parametrize("kw", BMX_SMALL, ids=["gated", "pruned"])
def test_clustered_corpus_equals_bench_bmx(kw):
    """Offsets, rows and value bits bit-equal to bench_bmx.decode (the rows
    to its jitted gen_device_csr too), the same query tiles, and
    build_chunk_meta on the tensors equal to the JAX package's on the
    decoded host arrays and to bench_bmx.analytic_meta (doc spans and
    window offsets exactly; the closed-form maxima an upper bound, tight
    but on the sub-blocks that straddle a regime boundary)."""
    cfg = corpora.make_cfg(**kw)
    want = bench_bmx.make_cfg(**kw, k=50)
    np.testing.assert_array_equal(cfg["offsets"], want["offsets"])
    nnz = cfg["NNZ"]
    rows, bits = corpora.gen_device_csr(cfg, CPU)
    doc, val, _, _ = bench_bmx.decode(np, np.arange(nnz, dtype=np.int64),
                                      want)
    np.testing.assert_array_equal(rows[:nnz].numpy(), doc)
    np.testing.assert_array_equal(bits[:nnz].numpy(),
                                  val.astype(np.float32).view(np.int32))
    assert (rows[nnz:] == cfg["N"]).all() and not bits[nnz:].any()
    # the jitted generator: the same rows; its values may sit one ulp off
    # decode's, where XLA contracts base + scale * x into one fused
    # multiply-add (the port, like decode, rounds the product first)
    j_rows, j_bits = (np.asarray(a)[:nnz + CHUNK]
                      for a in bench_bmx.gen_device_csr(want))
    np.testing.assert_array_equal(rows.numpy(), j_rows)
    assert np.abs(bits.numpy().astype(np.int64) - j_bits).max() <= 1
    for (a, b), (c, d) in zip(
            corpora.make_tiles(cfg, np.random.default_rng(1), 2, 8, 16),
            bench_bmx.make_tiles(want, np.random.default_rng(1), 2, tile=8,
                                 t_budget=16)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)

    meta = build_chunk_meta(cfg["offsets"], rows, bits.view(torch.float32))
    exact = ref_build_chunk_meta(cfg["offsets"], doc.astype(np.int32),
                                 val.astype(np.float32), sub=bench_bmx.SUB)
    for key in ("term_chunk_offset", "sub_max", "sub_lo", "sub_hi"):
        np.testing.assert_array_equal(meta[key], exact[key], err_msg=key)
    closed = bench_bmx.analytic_meta(want)
    for key in ("term_chunk_offset", "sub_lo", "sub_hi"):
        np.testing.assert_array_equal(meta[key], closed[key], err_msg=key)
    slack = closed["sub_max"] - meta["sub_max"]
    assert (slack > -1e-6).all() and np.median(slack) < 1e-5


def _bmx_small(monkeypatch):
    monkeypatch.setattr(bmx, "CFG", BMX_SMALL[1])
    for name, v in (("TILE", 8), ("T_BUDGET", 16), ("N_TILES", 3)):
        monkeypatch.setattr(bmx, name, v)


@pytest.mark.parametrize("topk", [50, 10])
def test_bmx_rehearsal(monkeypatch, capsys, topk):
    """At the configuration where pruning engages, two covers, and at the
    serving shape (top-10)."""
    _bmx_small(monkeypatch)
    rc = bmx.main(["--device", "cpu", "--topk", str(topk), "--cover",
                   "4,8"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["card"] == "cpu"
    assert set(line["arms"]) == {"base", "bmx@4", "bmx@8"}
    assert f"top-{topk}," in line["unit"]
    assert line["best_cover"] in line["arms"] and line["vs_baseline"] > 0
    for name in ("bmx@4", "bmx@8"):
        st = line["arms"][name]["stats"]
        assert st["pruned_tiles"] > 0, st
        assert line["arms"][name]["rows_identical"] > 0.5


# ---- the indexing pipeline (benches/indexing.py) --------------------------


def test_sparsified_encoder_equals_bench_indexing():
    """f32, tiny widths, the JAX package's weights carried across: the same
    top-L0 set a row, values within rtol 1e-5 (the frameworks sum the
    matmuls in other orders)."""
    fields = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, rope_theta=500000.0,
                  tie_word_embeddings=True, max_position_embeddings=131072,
                  rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192})
    ref_cfg = RefModelConfig(**fields, dtype=jnp.float32,
                             param_dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, ref_llama.init_params(ref_cfg, jax.random.PRNGKey(0)))
    ref = bench_indexing.SparsifiedEncoder(RefLlamaBiSparse(
        jax.tree_util.tree_map(jnp.asarray, params), ref_cfg), 32)
    cfg = ModelConfig(**fields)
    ours = indexing.SparsifiedEncoder(LlamaBiSparse(
        params_from_jax(params, cfg, "cpu"), cfg), 32)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 256, (4, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :5] = 0
    want = np.asarray(ref.encode(ids, mask))
    got = ours.encode(ids, mask).numpy()
    assert ((want > 0).sum(1) == 32).all()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_indexing_batches_equal_bench_indexing():
    got = indexing.make_batches(0, 128_256, 2)
    rng = np.random.default_rng(0)           # bench_indexing.py:95-100
    want = [{
        "input_ids": rng.integers(4, 128_256, (64, 192)).astype(np.int32),
        "attention_mask": np.ones((64, 192), np.int32),
        "ids": [f"d{b * 64 + i}" for i in range(64)],
    } for b in range(2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["attention_mask"],
                                      w["attention_mask"])
        assert g["ids"] == w["ids"]


def test_indexing_rehearsal(monkeypatch, capsys):
    for name, v in (("SEQ", 16), ("BZ", 8), ("T_PACK", 64), ("L0_DOC", 16),
                    ("MODEL", {"num_hidden_layers": 2, "hidden_size": 64,
                               "intermediate_size": 128,
                               "num_attention_heads": 4,
                               "num_key_value_heads": 2, "head_dim": 16,
                               "vocab_size": 2048})):
        monkeypatch.setattr(indexing, name, v)
    rc = indexing.main(["--device", "cpu", "--batches", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True and line["card"] == "cpu"
    arms = line["arms"]
    assert set(arms) == {"full", "packed"}
    assert arms["packed"]["fallback_batches"] == 0
    assert arms["full"]["l0_d"] == arms["packed"]["l0_d"] == 16
    assert line["value"] == arms["packed"]["psg_per_s"]


# ---- --topk on the serving drivers ----------------------------------------


def test_serving_rehearsal_at_top10(monkeypatch, capsys):
    _uniform_small(monkeypatch, serving)
    for name, v in (("WIDTHS", (2, 8)), ("POOL", 64)) + LADDER:
        monkeypatch.setattr(serving, name, v)
    rc = serving.main(["--device", "cpu", "--topk", "10"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    assert "top-10," in line["unit"]
