"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
GPU. This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed; ``tests/conftest.py`` imports JAX, hence
``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.index.inverted_index import SparseIndex
from scaling_retriever_tpu_torch.ops import blockmax as bmx
from scaling_retriever_tpu_torch.ops import cuda_lib, fetch, segsum, topm
from scaling_retriever_tpu_torch.ops import segsort_scoring as ss
from scaling_retriever_tpu_torch.utils.utils import tie_equal_topk

pytestmark = pytest.mark.cuda

SENTINEL = (1 << 24) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("layout", ["f32", "q8"])
def test_fetch_kernel_matches_plain(cuda, layout):
    rng = np.random.default_rng(4)
    V = 40
    lens = rng.integers(0, 2600, V)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    n = int(offsets[-1]) + fetch.CHUNK
    rows = rng.integers(1 << 22, SENTINEL, n).astype(np.int32)
    qt = rng.integers(0, V, (8, 12)).astype(np.int32)
    qv = rng.uniform(0.1, 2.0, (8, 12)).astype(np.float32)
    qv[rng.random(qv.shape) < 0.2] = 0.0
    table = fetch.job_table(_t(qt, cuda), _t(offsets, cuda), _t(qv, cuda),
                            64, n)[:4]
    before = cuda_lib.LAUNCHES[f"fetch_{layout}"]
    if layout == "f32":
        vals = rng.uniform(0.01, 3.0, n).astype(np.float32).view(np.int32)
        args = (_t(rows, cuda), _t(vals, cuda), *table, 64, SENTINEL)
        got, want = fetch.fetch_jobs(*args), fetch.fetch_jobs_plain(*args)
    else:
        codes = rng.integers(0, 256, n).astype(np.uint32)
        packed = ((rows.astype(np.uint32) << np.uint32(8)) | codes
                  ).view(np.int32)
        args = (_t(packed, cuda), *table, 64, SENTINEL)
        got, want = fetch.fetch_jobs_q8(*args), fetch.fetch_jobs_q8_plain(*args)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[f"fetch_{layout}"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] >= 1 << 23).sum()) > 0


def test_fetch_bf16_kernel_matches_plain(cuda):
    """B3: odd list heads, lists crossing 2048 boundaries, values of both
    signs differing from posting to posting (a swap of a word's halves or
    a lost sign bit would show), rows >= 2^23."""
    rng = np.random.default_rng(5)
    V = 40
    lens = rng.integers(0, 5000, V)
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    nnz = int(offsets[-1])
    n = nnz + fetch.CHUNK2
    rows = rng.integers(1 << 22, SENTINEL, n).astype(np.int32)
    packed = ss.pack_values_bf16(rng.uniform(-3, 3, nnz).astype(np.float32), n)
    qt = rng.integers(0, V, (8, 12)).astype(np.int32)
    qv = rng.uniform(0.1, 2.0, (8, 12)).astype(np.float32)
    qv[rng.random(qv.shape) < 0.2] = 0.0
    table = fetch.job_table(_t(qt, cuda), _t(offsets, cuda), _t(qv, cuda),
                            48, n, fetch.CHUNK2)[:4]
    args = (_t(rows, cuda), _t(packed, cuda), *table, 48, SENTINEL)
    before = cuda_lib.LAUNCHES["fetch_bf16"]
    got = fetch.fetch_jobs_bf16(*args)
    want = fetch.fetch_jobs_bf16_plain(*args)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fetch_bf16"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1].min()) < 0 < float(got[1].max())


def test_blockmax_site_matches_plain(cuda):
    """B1 at the block-max site: a host-built pass-1 table (plus an entry
    of weight -1, which must fetch nothing) through the kernel and the
    plain version, and through both rank tails."""
    rng = np.random.default_rng(6)
    V, N, per = 24, 20000, 3000
    rows = np.concatenate([np.sort(rng.choice(N, per, replace=False))
                           for _ in range(V)]).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, V * per).astype(np.float32)
    offsets = np.arange(V + 1, dtype=np.int64) * per
    meta = bmx.build_chunk_meta(offsets, rows, vals)
    qt = np.stack([rng.choice(V, 6, replace=False) for _ in range(4)]
                  ).astype(np.int32)
    qv = rng.uniform(0.2, 1.5, qt.shape).astype(np.float32)
    ov = bmx.build_overlay(meta, offsets, qt, qv, N)
    plan = bmx.job_table(ov, bmx.keep_entries(ov, bmx.cover_tau(ov, 40)))
    packed = plan["packed"].copy()
    free = int(np.flatnonzero(packed[3, 0] == 0)[0])
    packed[:, 0, free] = [int(packed[0, 0, 0]), 0, fetch.CHUNK,
                          np.float32(-1.0).view(np.int32)]
    pad = np.full(fetch.CHUNK, N, np.int32)
    rows_d = _t(np.concatenate([rows, pad]), cuda)
    bits_d = _t(np.concatenate([vals, pad * 0.0]).astype(np.float32)
                .view(np.int32), cuda)
    packed_d = _t(packed, cuda)
    J = plan["jobs_per_query"]
    inputs = bmx.fetch_inputs(packed_d, rows_d.shape[0])
    before = cuda_lib.LAUNCHES["fetch_f32_blockmax"]
    got = ss.KERNELS.fetch_bmx(rows_d, bits_d, *inputs, J, N)
    want = fetch.fetch_jobs_plain(rows_d, bits_d, *inputs, J, N)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fetch_f32_blockmax"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    k = 20
    a = bmx.blockmax_retrieve_dma(rows_d, bits_d, packed_d, k, J, N, 6).cpu()
    b = bmx.blockmax_retrieve_dma(rows_d, bits_d, packed_d, k, J, N, 6,
                                  ops=ss.PLAIN).cpu()
    sa, sb = a[:, :k].view(torch.float32).numpy(), b[:, :k].view(
        torch.float32).numpy()
    for q in range(4):
        tie_equal_topk(b[q, k:].numpy(), sb[q], a[q, k:].numpy(), sa[q],
                       rtol=1e-6)


def _sorted_runs(rng, nq, P, max_run, sentinel):
    keys = []
    for _ in range(nq):
        runs = rng.integers(1, max_run + 1, P)
        arr = np.repeat(np.arange(P, dtype=np.int32), runs)[:P]
        arr[P - int(rng.integers(0, P // 3)):] = sentinel
        keys.append(arr)
    return np.stack(keys)


@pytest.mark.parametrize("max_run", [1, 64, 128])
def test_segsum_kernel_matches_plain(cuda, max_run):
    rng = np.random.default_rng(max_run)
    sent = 1 << 20
    srow = _t(_sorted_runs(rng, 4, 8192, max_run, sent), cuda)
    dyadic = torch.randint(-8, 8, srow.shape, device=cuda).float() / 4
    dyadic = torch.where(srow == sent, 0.0, dyadic)
    assert torch.equal(segsum.segsum_mask(srow, dyadic, sent, max_run),
                       segsum.segsum_mask_plain(srow, dyadic, sent, max_run))
    real = torch.where(srow == sent, 0.0,
                       torch.rand(srow.shape, device=cuda) + 0.1)
    got = segsum.segsum_mask(srow, real, sent, max_run)
    want = segsum.segsum_mask_plain(srow, real, sent, max_run)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float(((got - want)[fin].abs() / want[fin]).max()) <= 1e-6


def test_topm_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    s = rng.standard_normal((8, 8 * 4096)).astype(np.float32)
    s[1] = np.round(s[1])                          # many ties
    s[2, :4096] = -np.inf                          # an empty block
    s[3, 4096:8192] = -np.inf
    s[3, 4096 + np.array([5, 9, 17])] = [1.0, 3.0, 2.0]   # < m finite
    st = _t(s, cuda)
    before = cuda_lib.LAUNCHES["topm"]
    v, i = topm.block_topm(st, 32, 4096)
    pv, pi = topm.block_topm_plain(st, 32, 4096)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["topm"] == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert i[3, 1].tolist() == [9, 17, 5] + [0] * 29


def _topm_blocks(rng, block):
    """Eight [block] rows: normals, rounded normals (ties), all equal, all
    -inf, -0.0/+0.0 alternating from lane 0, +0.0/-0.0 alternating with
    five positive lanes, normals with two +inf lanes, three finite values
    among -inf lanes."""
    x = np.zeros((8, block), np.float32)
    x[0] = rng.standard_normal(block)
    x[1] = np.round(rng.standard_normal(block) * 2)
    x[2] = 1.5
    x[3] = -np.inf
    x[4, 0::2] = -0.0
    x[5, 1::2] = -0.0
    x[5, rng.choice(block, 5, replace=False)] = 1.0
    x[6] = rng.standard_normal(block)
    x[6, [3, block // 2]] = np.inf
    x[7] = -np.inf
    x[7, [5, 9, 17]] = [1.0, 3.0, 2.0]
    return x


@pytest.mark.parametrize("m,block", [(1, 128), (128, 128), (32, 1024),
                                     (32, 4096), (125, 4096), (128, 4096),
                                     (7, 12288), (128, 16384)])
def test_topm_kernel_adversarial_blocks(cuda, m, block):
    """Kernel against plain, bit for bit, over the kernel's (m, block)
    range, on every adversarial block in every position of a 3-row slab."""
    rng = np.random.default_rng(m + block)
    x = _topm_blocks(rng, block)
    s = np.concatenate([x, np.roll(x, 3, axis=0), x[::-1]], axis=0)
    st = _t(s.reshape(3, 8 * block), cuda)
    v, i = topm.block_topm(st, m, block)
    pv, pi = topm.block_topm_plain(st, m, block)
    torch.cuda.synchronize()
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert (i[0, 2] == torch.arange(m, device=cuda)).all()       # all equal
    assert (i[0, 3] == 0).all() and torch.isneginf(v[0, 3]).all()
    assert (i[0, 4] == torch.arange(m, device=cuda)).all()       # +-0.0


def test_topm_kernel_limits(cuda):
    """The wrapper raises on a CUDA tensor outside the kernel's limits and
    launches at both ends of its block range."""
    for n, block in ((256, 64), (16512, 16512), (4000, 4000)):
        with pytest.raises(ValueError, match="block_topm kernel takes"):
            topm.block_topm(torch.zeros(2, n, device=cuda), 4, block)
    for block in (128, 16384):
        s = torch.randn(2, 2 * block, device=cuda)
        before = cuda_lib.LAUNCHES["topm"]
        v, i = topm.block_topm(s, 128, block)
        pv, pi = topm.block_topm_plain(s, 128, block)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["topm"] == before + 1
        assert torch.equal(v, pv) and torch.equal(i, pi)


def test_topm_kernel_at_a_top10_tile(cuda):
    """B5 at the m a top-10 tile hands it: the engine's rank tail at k 10
    over a 64-query slab of 512 jobs (the uniform index's tile, dyadic
    contributions so that B4 is exact), B5 held bit-equal to its plain
    version on the slab it is given, and the tile's top-10 equal to the
    plain path's."""
    seen = []

    def topm_checked(s, m, block):
        got = topm.block_topm(s, m, block)
        want = topm.block_topm_plain(s, m, block)
        seen.append((m, block, torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1])))
        return got

    g = torch.Generator(device=cuda).manual_seed(10)
    n_docs, P = 8_841_823, 512 * fetch.CHUNK
    rows = torch.randint(0, n_docs, (64, P), device=cuda, generator=g,
                         dtype=torch.int32)
    rows[:, -5000:] = n_docs                          # unused slots
    contrib = torch.randint(1, 32, (64, P), device=cuda, generator=g) / 16.0
    before = cuda_lib.LAUNCHES["topm"]
    got = ss._finish(*ss._rank_tail_async(
        rows, contrib, n_docs, 10, 64, ss.KERNELS._replace(
            topm=topm_checked)), 10)
    want = ss._finish(*ss._rank_tail_async(rows, contrib, n_docs, 10, 64,
                                           ss.PLAIN), 10)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["topm"] == before + 1
    assert len(seen) == 1 and seen[0][2], seen
    assert seen[0][:2] == (32, 4096)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segsort_kernels_match_plain_path(cuda):
    """The engine's kernel path against the plain path and a CPU engine,
    on a small real-valued index."""
    rng = np.random.default_rng(8)
    V, N = 96, 300
    rows = np.repeat(np.arange(N), 6)
    cols = np.concatenate([rng.choice(V, 6, replace=False) for _ in range(N)])
    vals = rng.uniform(0.1, 3.0, len(rows)).astype(np.float32)
    idx = SparseIndex.from_triples(rows, cols, vals, list(range(N)), V)
    qt = np.stack([rng.choice(V, 8, replace=False) for _ in range(4)]
                  ).astype(np.int32)
    qv = rng.uniform(0.2, 2.0, (4, 8)).astype(np.float32)
    for val_dtype in ("f32", "bf16", "q8"):
        gpu = ss.SegsortEngine(idx, topk=20, query_terms_budget=8,
                               val_dtype=val_dtype, device=cuda)
        cpu = ss.SegsortEngine(idx, topk=20, query_terms_budget=8,
                               val_dtype=val_dtype, device="cpu")
        s1, r1 = gpu.finalize(gpu.retrieve_tile_async(None, 20,
                                                      sparsified=(qt, qv)))
        s0, r0 = cpu.finalize(cpu.retrieve_tile_async(None, 20,
                                                      sparsified=(qt, qv)))
        for q in range(4):
            fin = np.isfinite(s0[q])
            tie_equal_topk(r0[q][fin], s0[q][fin], r1[q][fin], s1[q][fin],
                           rtol=1e-6)


@pytest.mark.parametrize("val_dtype", ["f32", "bf16", "q8"])
def test_sharded_engine_on_one_card_matches_plain(cuda, val_dtype):
    """Four shards on one card (a mesh of repeated entries) through the
    kernels, against the plain-ops sharded engine and the one-engine
    kernel path; every shard launches its fetch, segsum and top-m."""
    rng = np.random.default_rng(9)
    # long lists (~15,000 postings a term), so that each shard's slab is
    # wide enough (>= 4 blocks of 4096) to take B5
    V, N = 16, 40_000
    rows = np.repeat(np.arange(N), 6)
    cols = np.argsort(rng.random((N, V)), axis=1)[:, :6].reshape(-1)
    vals = (rng.integers(1, 64, len(rows)) / 16.0).astype(np.float32)
    idx = SparseIndex.from_triples(rows, cols, vals, list(range(N)), V)
    qt = np.stack([rng.choice(V, 8, replace=False) for _ in range(8)]
                  ).astype(np.int32)
    qv = (rng.integers(1, 16, (8, 8)) / 8.0).astype(np.float32)
    kw = dict(topk=50, query_terms_budget=8, val_dtype=val_dtype)
    sharded = ss.ShardedSegsortEngine(idx, [cuda] * 4, **kw)
    plain = ss.ShardedSegsortEngine(idx, [cuda] * 4, ops=ss.PLAIN, **kw)
    fetch_key = {"f32": "fetch_f32", "bf16": "fetch_bf16",
                 "q8": "fetch_q8"}[val_dtype]
    cuda_lib.reset_launches()
    s1, r1 = sharded.finalize(sharded.retrieve_tile_async(
        None, sparsified=(qt, qv)))
    counts = dict(cuda_lib.LAUNCHES)
    assert all(counts[k] == 4 for k in (fetch_key, "segsum", "topm")), counts
    s0, r0 = plain.finalize(plain.retrieve_tile_async(
        None, sparsified=(qt, qv)))
    if val_dtype == "q8":
        # the folded scales make the contributions inexact and B4 sums a
        # run right to left: within 1e-6, as for one engine. Each shard
        # scales its own terms, so one engine's q8 codes differ
        for q in range(8):
            tie_equal_topk(r0[q], s0[q], r1[q], s1[q], rtol=1e-6)
        return
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(r1, r0)
    one = ss.SegsortEngine(idx, device=cuda, **kw)
    s2, r2 = one.finalize(one.retrieve_tile_async(None,
                                                  sparsified=(qt, qv)))
    for q in range(8):
        tie_equal_topk(r2[q], s2[q], r1[q], s1[q], rtol=0.0)


def test_topm_kernel_at_a_dense_like_slab(cuda):
    """B5 on an f32-output product of bf16 unit vectors with a zero tail
    (the padding rows of a dense index's last chunk): bit-equal to the
    plain loop, tied zero blocks return lanes 0..m-1."""
    from scaling_retriever_tpu_torch.index import dense_index as di

    g = torch.Generator(device=cuda).manual_seed(9)
    docs = torch.randn(4 * 4096, 256, device=cuda, generator=g)
    docs = torch.nn.functional.normalize(docs, dim=1).bfloat16()
    docs[-5000:] = 0                       # blocks 3 and part of 2: zeros
    q = torch.nn.functional.normalize(
        torch.randn(32, 256, device=cuda, generator=g), dim=1).bfloat16()
    s = di._score_slab(q, docs, None, None)
    assert s.dtype == torch.float32
    before = cuda_lib.LAUNCHES["topm"]
    v, i = topm.block_topm(s, 32, 4096)
    pv, pi = topm.block_topm_plain(s, 32, 4096)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["topm"] == before + 1
    assert torch.equal(v, pv) and torch.equal(i, pi)
    lanes = torch.arange(32, device=cuda, dtype=torch.int32)
    assert bool((i[:, 3] == lanes).all()) and bool((v[:, 3] == 0).all())


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_dense_search_on_card_matches_cpu(cuda, quantize):
    """DenseFlatIndexer on the card (B5 in the blocked path, the f32-output
    bf16 product or the int8 product with an 8-row tile padded for it)
    against the same index on the CPU: dyadic data, so scores bit-equal
    and rows tie-equal."""
    from scaling_retriever_tpu_torch.index.dense_index import \
        DenseFlatIndexer

    rng = np.random.default_rng(10)
    n, d, k = 3 * 8192 - 100, 64, 50
    docs = (rng.integers(-16, 17, (n, d)) / 16.0).astype(np.float32)
    q = (rng.integers(-16, 17, (40, d)) / 16.0).astype(np.float32)
    kw = dict(chunk=8192, sel_block=1024, block_m=16, query_tile=32,
              quantize=quantize)
    gpu = DenseFlatIndexer(device=cuda, **kw)
    cpu = DenseFlatIndexer(device="cpu", **kw)
    for ix in (gpu, cpu):
        ix.init_index(d)
        ix.add_batch(range(n), docs)
    assert gpu._topm() == "pallas" and cpu._topm() == "xla"
    before = cuda_lib.LAUNCHES["topm_dense"]
    for nq in (40, 8):
        got = gpu.search_knn(q[:nq], k)
        want = cpu.search_knn(q[:nq], k)
        for (gi, gs), (wi, ws) in zip(got, want):
            assert np.asarray(gs, np.float32).tobytes() == \
                np.asarray(ws, np.float32).tobytes()
            tie_equal_topk(gi, gs, wi, ws, rtol=0.0)
    # one launch per chunk of each blocked tile (tiles of 32 + 8, then 8);
    # a rerun of an uncertified tile takes the direct path, without B5
    assert cuda_lib.LAUNCHES["topm_dense"] == before + 3 * 3


def test_dense_layout_from_host_store_on_card(cuda, monkeypatch):
    """Numpy rows stay in a host store; the bf16 and int8 layouts built on
    the card through the two pinned buffers (three copies per chunk, the
    last one short) equal the CPU's bit for bit."""
    from scaling_retriever_tpu_torch.index import dense_index

    monkeypatch.setattr(dense_index, "MOVE_ROWS", 1000)
    rng = np.random.default_rng(11)
    v = rng.standard_normal((5000, 64)).astype(np.float32)
    for quantize in (None, "int8"):
        gpu = dense_index.DenseFlatIndexer(device=cuda, chunk=2048,
                                           quantize=quantize)
        cpu = dense_index.DenseFlatIndexer(device="cpu", chunk=2048,
                                           quantize=quantize)
        for ix in (gpu, cpu):
            ix.init_index(64)
            ix.add_batch(range(5000), v)
        assert {b.device.type for b in gpu._store} == {"cpu"}
        got, want = gpu._materialize(), cpu._materialize()
        assert all(g.device.type == "cuda" and torch.equal(g.cpu(), w)
                   for g, w in zip(got, want))
        if quantize:
            assert all(torch.equal(g.cpu(), w) for g, w
                       in zip(gpu._layout[2], cpu._layout[2]))


# -- the encoder's tile graphs ----------------------------------------------

TILE_T = 16


class _EchoServer:
    """Stands in for the retrieval server: a request's result is its rep."""

    backend = None

    def submit(self, rep, topk=None):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(rep)
        return fut


def _tiny_encoder(family, dev, vocab=20000, head_dim=None):
    """A Qwen2-shaped encoder (q/k/v bias, tied head, GQA 3:1), a
    Mistral-shaped one (untied head, GQA 4:1), a Llama-shaped one (tied
    head, GQA 4:1, llama3 rope scaling; heads of ``head_dim`` where given,
    else 16) or a DeepSeek-V2-shaped one (latent attention, yarn rope as
    published, a dense layer then one of 8 routed experts, top-2, and a
    shared one, at widths the expert kernels take), bf16 as configured,
    with random q/k/v biases."""
    from scaling_retriever_tpu_torch.models import deepseek_v2, encoder
    from scaling_retriever_tpu_torch.models.config import ModelConfig
    from scaling_retriever_tpu_torch.models.weights import random_params

    bf16 = {"dtype": torch.bfloat16, "param_dtype": torch.bfloat16}
    if family == "deepseek_v2":
        cfg = ModelConfig.from_hf_config({
            "model_type": "deepseek_v2", "vocab_size": vocab,
            "hidden_size": 256, "intermediate_size": 512,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "kv_lora_rank": 64,
            "q_lora_rank": None, "qk_nope_head_dim": 32,
            "qk_rope_head_dim": 16, "v_head_dim": 32,
            "n_routed_experts": 8, "n_shared_experts": 1,
            "num_experts_per_tok": 2, "moe_intermediate_size": 128,
            "first_k_dense_replace": 1, "moe_layer_freq": 1,
            "norm_topk_prob": False, "routed_scaling_factor": 1,
            "scoring_func": "softmax", "topk_method": "greedy",
            "rms_norm_eps": 1e-6, "rope_theta": 10000,
            "tie_word_embeddings": False,
            "max_position_embeddings": 163840,
            "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                             "mscale": 0.707, "mscale_all_dim": 0.707,
                             "original_max_position_embeddings": 4096,
                             "type": "yarn"}}, **bf16)
        params = deepseek_v2.empty_model(cfg, dev)
        g = torch.Generator(device=dev).manual_seed(3)
        with torch.no_grad():
            for p in params.parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=g)
        return encoder.DeepseekV2BiSparse(params, cfg)
    qwen = family == "qwen2"
    llama3 = {"factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
              "original_max_position_embeddings": 64, "rope_type": "llama3"}
    cfg = ModelConfig(
        vocab_size=vocab, hidden_size=96 if qwen else 128,
        intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=6 if qwen else 8,
        num_key_value_heads=2, head_dim=head_dim,
        rope_theta=1e6 if qwen else 1e4,
        rope_scaling=llama3 if family == "llama" else None,
        tie_word_embeddings=family != "mistral", attention_qkv_bias=qwen,
        model_type=family, **bf16)
    params = random_params(cfg, 3, dev)
    if qwen:
        g = torch.Generator(device=dev).manual_seed(4)
        with torch.no_grad():
            for layer in params.layers:
                for name in ("wq", "wk", "wv"):
                    getattr(layer, name).bias.normal_(0.0, 0.5, generator=g)
    return {"qwen2": encoder.Qwen2BiSparse,
            "mistral": encoder.MistralBiSparse,
            "llama": encoder.LlamaBiSparse}[family](params, cfg)


def _tile_texts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{x}" for x in rng.integers(1, vocab,
                                                    rng.integers(3, 15)))
            for _ in range(n)]


@pytest.mark.parametrize("family", ["llama", "qwen2", "mistral",
                                    "deepseek_v2"])
def test_graphed_tiles_equal_eager_tiles(cuda, family):
    """At each (width, rung) of a two-width, two-rung ladder a replayed
    tile's (terms, vals) equal the eager tile's bit for bit, and tile n's
    returned tensors still hold tile n's values after tile n+1 replays.
    The Llama family's tiles, captured and eager, run the attention
    kernel once a layer (the weights need no gradient); DeepSeek-V2's
    latent attention never launches it."""
    from scaling_retriever_tpu_torch.benches.common import StandInTokenizer
    from scaling_retriever_tpu_torch.models import tile_graphs
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn, make_encode_fn_handoff)

    model = _tiny_encoder(family, cuda)
    vocab = model.vocab_size
    per_tile = (0 if family == "deepseek_v2"
                else model.config.num_hidden_layers)
    tok = StandInTokenizer(vocab, (8, 16))
    fe = QueryEncoderFrontend(_EchoServer(), make_encode_fn(model, TILE_T),
                              tok, widths=(4, 8), t_sparse=TILE_T)
    texts = _tile_texts(5, 16, vocab)
    launched = cuda_lib.LAUNCHES["rope_attention"]
    fe.warmup(texts[:4], passes=2)
    assert len(model.tile_graphs) == 4
    launched = cuda_lib.LAUNCHES["rope_attention"] - launched
    assert (launched > 0) == (per_tile > 0), launched
    encode = make_encode_fn_handoff(model, TILE_T)
    for width in (4, 8):
        for rung in (8, 16):
            tiles = [tok(texts[i:i + width], length=rung)
                     for i in (0, width)]
            n0 = tile_graphs.replays()
            with torch.no_grad():
                got = [encode(*t) for t in tiles]
            assert tile_graphs.replays() == n0 + 2
            launched = cuda_lib.LAUNCHES["rope_attention"]
            with torch.enable_grad():
                want = [encode(*t) for t in tiles]
            assert tile_graphs.replays() == n0 + 2
            assert (cuda_lib.LAUNCHES["rope_attention"] - launched
                    == 2 * per_tile)
            torch.cuda.synchronize()
            assert not torch.equal(got[0][1], got[1][1])
            for g, w in zip(got, want):
                assert (g[0].dtype, g[1].dtype) == (torch.int32,
                                                     torch.float32)
                assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            assert int((got[0][1] > 0).sum()) > 0


def _kernel_only_without_grad(model, dev):
    """A forward with grad off launches the attention kernel once a layer;
    one autograd records (the weights require grad, as under training)
    launches it zero times and runs apply_rope and attention, within bf16
    roundings of the kernel's forward."""
    params = model.params
    g = torch.Generator(device=dev).manual_seed(8)
    ids = torch.randint(2, model.vocab_size, (6, 24), generator=g,
                        device=dev)
    mask = torch.ones_like(ids)
    mask[0, :23] = 0
    mask[1, :9] = 0
    before = cuda_lib.LAUNCHES["rope_attention"]
    with torch.no_grad():
        fused = params.forward_hidden(ids, mask)
    assert (cuda_lib.LAUNCHES["rope_attention"] - before
            == model.config.num_hidden_layers)
    params.requires_grad_(True)
    before = cuda_lib.LAUNCHES["rope_attention"]
    recorded = params.forward_hidden(ids, mask)
    recorded.float().sum().backward()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["rope_attention"] == before
    assert recorded.requires_grad
    err = ((fused.float() - recorded.detach().float()).norm()
           / recorded.detach().float().norm()).item()
    assert err < 2 ** -6, err


@pytest.mark.parametrize("family", ["llama", "qwen2", "mistral"])
def test_attention_kernel_runs_only_where_no_gradient_flows(cuda, family):
    """The kernel on the no-grad forward only (``_kernel_only_without_grad``),
    in each Llama-family encoder."""
    _kernel_only_without_grad(_tiny_encoder(family, cuda), cuda)


@pytest.mark.parametrize("head_dim", [32, 80])
def test_attention_kernel_serves_other_head_dims(cuda, head_dim):
    """A Llama model whose heads are another multiple of 16 than the
    benchmark's 64 and 128 runs its no-grad forward through the kernel,
    as any head dim the kernel takes (multiples of 16 up to 128)."""
    model = _tiny_encoder("llama", cuda, head_dim=head_dim)
    assert model.config.head_dim_ == head_dim
    _kernel_only_without_grad(model, cuda)


def test_attention_kernel_refuses_other_head_dims_at_the_first_forward(
        cuda):
    """A head dim the kernel does not take (not a multiple of 16, or past
    128) raises at the model's first no-grad forward on the card, naming
    what it takes; the forward autograd records still runs."""
    model = _tiny_encoder("llama", cuda, head_dim=24)
    ids = torch.randint(2, model.vocab_size, (2, 8), device=cuda)
    mask = torch.ones_like(ids)
    with torch.no_grad(), pytest.raises(ValueError, match="multiples of 16"):
        model.params.forward_hidden(ids, mask)
    model.params.requires_grad_(True)
    assert model.params.forward_hidden(ids, mask).requires_grad


@pytest.mark.parametrize("family", ["llama", "deepseek_v2"])
def test_a_seen_length_runs_rope_without_a_sync(cuda, family):
    """Building a length's rope tables copies the frequencies from the
    host and waits for the copy; the model keeps the tables, so a second
    eager forward at that length runs no synchronising operation in rope
    (``torch.cuda.set_sync_debug_mode``). A table built afresh is the
    control: its sync is seen. The forward's other synchronising
    operations, if any, are printed (``-rP``)."""
    import traceback
    import warnings

    from scaling_retriever_tpu_torch.models import llama

    model = _tiny_encoder(family, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(2, model.vocab_size, (4, 16), generator=g,
                        device=cuda)
    mask = torch.ones_like(ids)
    syncs = []

    def record(message, *args, **kwargs):
        # not the notice that the debug mode is a prototype
        if "synchronizing" in str(message) and "prototype" not in str(
                message):
            syncs.append(traceback.extract_stack()[:-1])

    def synced(fn):
        del syncs[:]
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return [[f.name for f in stack] for stack in syncs]

    with torch.no_grad():
        model.params.forward_hidden(ids, mask)
        torch.cuda.synchronize()
        seen = synced(lambda: model.params.forward_hidden(ids, mask))
        control = synced(lambda: llama.rope_cos_sin(model.config, 16, cuda))
    torch.cuda.synchronize()
    assert list(model.params.rope.built) == [(16, ids.device)]
    assert any("rope_cos_sin" in names for names in control)
    for names in seen:
        print(family, "sync in", " > ".join(names[-5:-1]))
    assert not any("rope_cos_sin" in names for names in seen)


def test_unwarmed_shapes_and_grad_run_eager(cuda):
    """The frontend replays only the shapes its encoder captured, and only
    with grad off: a width no warm-up declared, and a tile dispatched with
    grad on, run eager and count under ``eager_tiles``. The served reps
    equal the eager tile's."""
    from concurrent.futures import Future

    from scaling_retriever_tpu_torch.benches.common import StandInTokenizer
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn)

    model = _tiny_encoder("qwen2", cuda)
    vocab = model.vocab_size
    tok = StandInTokenizer(vocab, (16,))
    texts = _tile_texts(6, 24, vocab)
    warmed = QueryEncoderFrontend(_EchoServer(), make_encode_fn(model, TILE_T),
                                  tok, widths=(4,), t_sparse=TILE_T)
    warmed.warmup(texts[:4], passes=2)
    assert len(model.tile_graphs) == 1
    cold = QueryEncoderFrontend(_EchoServer(), make_encode_fn(model, TILE_T),
                                tok, widths=(8,), t_sparse=TILE_T)
    served = {}
    for fe, chunk in ((warmed, texts[:12]), (cold, texts[12:])):
        with fe:
            fe.start()
            futs = [(t, fe.submit_text(t)) for t in chunk]
            served.update((t, (f.result(timeout=60), fe.widths[0]))
                          for t, f in futs)
    w, c = warmed.stats(), cold.stats()
    assert w["graph_tiles"] == w["n_encode_batches"] >= 3
    assert w["eager_tiles"] == 0
    assert c["graph_tiles"] == 0 and c["eager_tiles"] == c["n_encode_batches"]
    assert len(model.tile_graphs) == 1
    # a tile of the captured shape dispatched with grad on
    reqs = [(t, None, Future(), 0, i) for i, t in enumerate(texts[:4])]
    with torch.enable_grad():
        item = warmed._dispatch_batch(reqs)
    assert item is not None
    assert warmed.stats()["graph_tiles"] == w["graph_tiles"]
    assert warmed.stats()["eager_tiles"] == 1
    encode = make_encode_fn(model, TILE_T)
    for t, ((terms, vals), width) in served.items():
        with torch.enable_grad():        # eager, at the serving tile's shape
            packed = encode(*tok([t] * width))
        keep = packed[0, TILE_T:] > 0
        np.testing.assert_array_equal(terms, packed[0, :TILE_T][keep])
        np.testing.assert_array_equal(vals, packed[0, TILE_T:][keep])


def test_tile_graph_pools_are_freed_with_the_encoder(cuda):
    """A captured 64 x 64 tile over a 32,000-term vocabulary holds hundreds
    of MB in its pool; deleting the encoder and its frontend returns them."""
    import gc

    from scaling_retriever_tpu_torch.benches.common import StandInTokenizer
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda)
    model = _tiny_encoder("mistral", cuda, vocab=32000)
    fe = QueryEncoderFrontend(_EchoServer(), make_encode_fn(model, TILE_T),
                              StandInTokenizer(32000, (64,)), widths=(64,),
                              t_sparse=TILE_T)
    fe.warmup(_tile_texts(7, 8, 32000), passes=2)
    assert len(model.tile_graphs) == 1
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda) - base
    assert held > 256 << 20
    del fe, model
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) - base < 64 << 20
