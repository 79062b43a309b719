"""DeepSeek-V2 as a sparse encoder (``models/deepseek_v2.py``,
``ops/moe.py``) on the CPU, against the benchmark's plain reference
(``retrieval_bench/reference/deepseek_v2.py``) on a tiny configuration of
the published shape: hidden 64, 4 heads, rope 8 / nope 16 / v 16, a
32-wide latent, 8 experts with top-3 and 2 shared, a dense layer 0 and 2
MoE layers, yarn rope as published. Also the yarn tables, the checkpoint
loader, the encoder registry, the benchmark arch's FLOP counts and the
two routed-expert readers on hand-made trace records."""

from __future__ import annotations

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from retrieval_bench import flops, gen, run
from retrieval_bench.archs import deepseek_v2 as arch
from retrieval_bench.reference import deepseek_v2 as ref
from retrieval_bench.tests.helpers import SEED
from scaling_retriever_tpu_torch.models import (deepseek_v2, encoder,
                                                hf_loader, llama,
                                                safetensors_io)
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import moe
from scaling_retriever_tpu_torch.utils import profiling

CELL = "deepseek-v2-lite.text-long"
F32 = {"dtype": torch.float32, "param_dtype": torch.float32}
# float32 on both sides: the port and the reference sum in other orders
# (attention einsums split at the rope part, the experts summed by slot
# rather than by expert, a finite padding bias against -inf); at these
# widths that moves a rep by ~1e-7 of its largest value, well under 1e-5
REP_RTOL = 1e-5

TINY = {"model_type": "deepseek_v2", "hidden_size": 64,
        "intermediate_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
        "n_shared_experts": 2, "num_experts_per_tok": 3,
        "moe_intermediate_size": 32, "first_k_dense_replace": 1,
        "moe_layer_freq": 1, "norm_topk_prob": False,
        "routed_scaling_factor": 1, "scoring_func": "softmax",
        "topk_method": "greedy", "rms_norm_eps": 1e-6, "rope_theta": 10000,
        "vocab_size": 512, "tie_word_embeddings": False,
        "max_position_embeddings": 163840,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}
TINY_CONF = {"model": TINY, "arch": "deepseek_v2",
             "encoder": "DeepseekV2BiSparse",
             "index": {"n_docs": 5000, "postings_per_doc": 16}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts(n: int = 5, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [list(rng.integers(2, 512, int(k))) for k in
            rng.integers(3, 12, n)]


def _left_padded(toks: list) -> tuple:
    s = max(len(t) for t in toks)
    ids = np.zeros((len(toks), s), np.int32)
    mask = np.zeros((len(toks), s), np.int32)
    for i, t in enumerate(toks):
        ids[i, s - len(t):] = t
        mask[i, s - len(t):] = 1
    return ids, mask


@pytest.fixture(scope="module")
def enc():
    return arch.build_encoder(TINY_CONF, SEED, "cpu", **F32)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_the_port_matches_the_reference_in_float32(enc):
    toks = _texts()
    got = enc.encode(*_left_padded(toks))
    want = ref.sparse_reps(TINY, SEED, toks, "cpu")
    assert got.shape == want.shape == (len(toks), 512)
    assert _rel(got, want) < REP_RTOL


def test_the_port_routes_as_the_reference(enc):
    toks = _texts()
    ids, mask = _left_padded(toks)
    got = []
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, inp, out: got.append(out[1].view(len(toks), -1, 3)))
        for layer in enc.params.layers if layer.is_moe]
    try:
        enc.encode(ids, mask)
    finally:
        for h in hooks:
            h.remove()
    want = []
    ref.sparse_reps(TINY, SEED, toks, "cpu", routes=want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for i, t in enumerate(toks):
            port = g[i, ids.shape[1] - len(t):].sort(-1).values
            assert torch.equal(port, w[i, :len(t)].sort(-1).values)


def test_the_routing_draw_routes_by_the_token_embedding(enc):
    """No layer writes the residual dims the router reads, so they still
    hold each token's embedding at every MoE layer's router."""
    dims = TINY["hidden_size"] // ref.ROUTE_SHARE
    moe_layers = [layer for layer in enc.params.layers if layer.is_moe]
    seen = []
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0])) for layer in moe_layers]
    ids, mask = _left_padded(_texts())
    enc.encode(ids, mask)
    for h in hooks:
        h.remove()
    emb = enc.params.embed_tokens.weight[torch.as_tensor(ids).long()]
    emb = emb.reshape(-1, TINY["hidden_size"])[:, :dims]
    assert len(seen) == len(moe_layers) == 2
    for layer, x in zip(moe_layers, seen):
        assert not layer.mlp.gate.weight[:, dims:].any()
        # the router input is RMSNorm(h) * g: h's first dims are the
        # embedding's, up to each row's norm
        scale = x[:, :dims] / (emb * layer.post_attn_norm[:dims])
        assert torch.allclose(scale, scale[:, :1].expand_as(scale),
                              rtol=1e-5)


def test_the_plain_expert_layer_is_a_per_expert_loop():
    g = torch.Generator().manual_seed(5)
    n, h, f, e, k = 11, 16, 8, 6, 3
    x = torch.randn(n, h, generator=g)
    w_gu = torch.randn(e, 2 * f, h, generator=g) * 0.3
    w_d = torch.randn(e, h, f, generator=g) * 0.3
    shared = torch.randn(n, h, generator=g)
    ids = torch.topk(torch.rand(n, e, generator=g), k, dim=1).indices
    wt = torch.rand(n, k, generator=g)
    load = torch.zeros(e, dtype=torch.int64)
    got = moe.routed_experts(x, ids, wt, w_gu, w_d, shared, load)
    want = shared.clone()
    for t in range(n):
        for j in range(k):
            we = w_gu[ids[t, j]]
            mid = torch.nn.functional.silu(we[:f] @ x[t]) * (we[f:] @ x[t])
            want[t] += wt[t, j] * (w_d[ids[t, j]] @ mid)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(load, torch.bincount(ids.flatten(), minlength=e))
    r = moe.route(ids, e)
    assert torch.equal(r.order[r.inv.long()].long(), torch.arange(n * k))
    assert torch.equal(ids.flatten()[r.order.long()],
                       ids.flatten()[r.order.long()].sort().values)


@pytest.mark.parametrize("tokens,k", [
    (8 * 64, 6),         # the text cell's 8-wide tile: 48 slots an expert
    (64 * 64, 6),        # its 64-wide tile: 384 slots an expert
    (1366, 6),
    (7, 2),
    (1, 1)])
def test_the_products_launch_one_kernel_each_on_the_routings_counters(
        monkeypatch, tokens, k):
    """Each product launches its one kernel, counted under its own name,
    with the routing's work counter of its own (up the first, down the
    second); ``cuda_lib.launch`` is recorded here instead of run."""
    e, h, i = 64, 256, 128
    calls = []
    monkeypatch.setattr(moe, "_on_card", lambda t, name: True)
    monkeypatch.setattr(moe.cuda_lib, "check_cuda", lambda *a: None)
    monkeypatch.setattr(moe.cuda_lib, "launch",
                        lambda key, entry, dev, *args: calls.append(
                            (key, entry, args)))
    r = moe.route_plain(torch.zeros(tokens, k, dtype=torch.int64), e)
    assert torch.equal(r.work, torch.zeros(2, dtype=torch.int32))
    bf16 = torch.bfloat16
    hmid = moe.expert_up(torch.empty(tokens, h, dtype=bf16), r,
                         torch.empty(e, 2 * i, h, dtype=bf16), k)
    y = moe.expert_down(hmid, r, torch.empty(e, h, i, dtype=bf16),
                        torch.empty(tokens, k))
    assert (hmid.shape, y.shape) == ((tokens * k, i), (tokens * k, h))
    (up, up_entry, up_args), (down, down_entry, down_args) = calls
    assert (up, up_entry, down, down_entry) == (
        "moe_expert_up", "srt_moe_expert_up", "moe_expert_down",
        "srt_moe_expert_down")
    work = r.work.data_ptr()
    assert (up_args[5], down_args[6]) == (work, work + 4)
    assert up_args[6:] == (tokens * k, e, k, h, i)
    assert down_args[7:] == (tokens * k, e, h, i)
    # the keys the products count under name the kernel, as the
    # benchmark's readers find the kernels by ``moe_expert``
    assert [key for key in moe.cuda_lib.LAUNCHES if "moe_expert" in key] == [
        "moe_expert_up", "moe_expert_down"]


def test_the_expert_load_counts_every_slot(enc):
    enc.params.reset_expert_load()
    ids, mask = _left_padded(_texts())
    enc.encode(ids, mask)
    load = enc.params.expert_load()
    assert load.shape == (2, 8)
    assert int(load.sum()) == ids.size * 3 * 2
    assert (load.sum(1) == ids.size * 3).all()
    enc.params.reset_expert_load()
    assert int(enc.params.expert_load().sum()) == 0


def test_yarn_tables_follow_the_closed_form():
    cfg = ModelConfig.from_hf_config(TINY)
    d, base, rs = 8, 10000.0, TINY["rope_scaling"]
    old = rs["original_max_position_embeddings"]

    def corr(rot):
        return d * math.log(old / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), d - 1)
    want = []
    for j in range(d // 2):
        f = base ** (-2 * j / d)
        ramp = min(max((j - lo) / (hi - lo), 0.0), 1.0)
        want.append(f / 40 * ramp + f * (1 - ramp))
    got = llama.rope_inv_freq(cfg)
    assert np.allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # mscale(40, 0.707) / mscale(40, 0.707): the tables are plain cos, sin
    cos, sin = llama.rope_cos_sin(cfg, 5, "cpu")
    ang = np.arange(5)[:, None] * np.concatenate([want, want])[None]
    assert np.allclose(cos.numpy(), np.cos(ang), atol=1e-6)
    assert np.allclose(sin.numpy(), np.sin(ang), atol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1.0
    assert deepseek_v2.softmax_scale(cfg) == pytest.approx(
        (16 + 8) ** -0.5 * m * m, rel=1e-12)
    cr, sr = ref.rope_tables(TINY, 5, "cpu")
    assert torch.allclose(cr, cos, atol=1e-6)
    assert torch.allclose(sr, sin, atol=1e-6)


def _old_inv_freq(config: ModelConfig) -> torch.Tensor:
    """The rope frequencies as the port computed them before yarn."""
    hd = config.head_dim_
    inv = 1.0 / (config.rope_theta
                 ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd))
    rs = config.rope_scaling
    kind = None if rs is None else rs.get("rope_type", rs.get("type"))
    if kind == "linear":
        return inv / rs["factor"]
    if kind == "llama3":
        factor, low, high = (rs["factor"], rs["low_freq_factor"],
                             rs["high_freq_factor"])
        old = rs["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv
        scaled = torch.where(wavelen > old / low, inv / factor, inv)
        smooth = (old / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= old / high) & (wavelen <= old / low)
        return torch.where(medium, smoothed, scaled)
    return inv


@pytest.mark.parametrize("rope_scaling", [
    None, {"rope_type": "default"}, {"rope_type": "linear", "factor": 4.0},
    {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
     "original_max_position_embeddings": 8192, "rope_type": "llama3"}])
def test_llama_rope_types_are_unchanged(rope_scaling):
    cfg = ModelConfig(rope_scaling=rope_scaling)
    assert torch.equal(llama.rope_inv_freq(cfg), _old_inv_freq(cfg))
    cos, sin = llama.rope_cos_sin(cfg, 7, "cpu")
    f = torch.arange(7, dtype=torch.float32)[:, None] * _old_inv_freq(cfg)
    emb = torch.cat([f, f], -1)
    assert torch.equal(cos, emb.cos()) and torch.equal(sin, emb.sin())


def _hf_named(m: dict, seed: int) -> dict:
    """The benchmark's bf16 weights under HF DeepSeek-V2's tensor names,
    each expert apart."""
    emb = gen.embed_weights(m, seed, "cpu")
    out = {"model.embed_tokens.weight": emb["embed"],
           "model.norm.weight": emb["final_norm"],
           "lm_head.weight": gen.head_weight(m, seed, "cpu")}
    attn = {"wq": "self_attn.q_proj", "wkv_a": "self_attn.kv_a_proj_with_mqa",
            "kv_norm": "self_attn.kv_a_layernorm", "wkv_b":
            "self_attn.kv_b_proj", "wo": "self_attn.o_proj",
            "input_norm": "input_layernorm",
            "post_attn_norm": "post_attention_layernorm",
            "wg": "mlp.gate_proj", "wu": "mlp.up_proj", "wd": "mlp.down_proj",
            "router": "mlp.gate", "sg": "mlp.shared_experts.gate_proj",
            "su": "mlp.shared_experts.up_proj",
            "sd": "mlp.shared_experts.down_proj"}
    f = m["moe_intermediate_size"]
    for i in range(m["num_hidden_layers"]):
        w = ref.layer_weights(m, seed, i, "cpu")
        pre = f"model.layers.{i}."
        for name, t in w.items():
            if name == "w_gu":
                for e in range(t.shape[0]):
                    out[f"{pre}mlp.experts.{e}.gate_proj.weight"] = t[e, :f]
                    out[f"{pre}mlp.experts.{e}.up_proj.weight"] = t[e, f:]
            elif name == "w_d":
                for e in range(t.shape[0]):
                    out[f"{pre}mlp.experts.{e}.down_proj.weight"] = t[e]
            else:
                out[f"{pre}{attn[name]}.weight"] = t
    return out


def test_an_hf_named_checkpoint_loads_to_the_same_reps(enc, tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    safetensors_io.save_file(_hf_named(TINY, SEED),
                             str(ckpt / "model.safetensors"))
    with open(ckpt / "config.json", "w") as f:
        json.dump(dict(TINY, architectures=["DeepseekV2ForCausalLM"]), f)
    assert encoder.encoder_class(str(ckpt), "sparse") is \
        encoder.DeepseekV2BiSparse
    assert encoder.encoder_class(str(ckpt), "dense") is \
        encoder.DeepseekV2BiDense
    loaded = encoder.load_encoder(str(ckpt), "sparse", device="cpu", **F32)
    assert isinstance(loaded.params, deepseek_v2.DeepseekV2BiForMNTP)
    ids, mask = _left_padded(_texts())
    want = enc.encode(ids, mask)
    assert torch.equal(loaded.encode(ids, mask), want)
    # inference only: the port writes no DeepSeek-V2 checkpoint
    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        loaded.save_pretrained(str(tmp_path / "again"))
    assert not (tmp_path / "again").exists()


def test_a_checkpoint_short_of_an_expert_is_refused(tmp_path):
    tensors = _hf_named(TINY, SEED)
    del tensors["model.layers.2.mlp.experts.5.up_proj.weight"]
    with pytest.raises(ValueError, match="lacks 1 tensors"):
        hf_loader.dsv2_params_from_hf_tensors(
            tensors, ModelConfig.from_hf_config(TINY, **F32), "cpu")


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("scoring_func", "sigmoid"),
    ("topk_method", "noaux_tc"), ("topk_method", "group_limited_greedy")])
def test_an_unimplemented_setting_raises_naming_its_key(key, value):
    with pytest.raises(NotImplementedError, match=key):
        ModelConfig.from_hf_config(dict(TINY, **{key: value}))


def test_training_and_sharding_raise_naming_the_architecture(enc):
    ids, mask = (torch.as_tensor(a) for a in _left_padded(_texts()))
    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        enc.params.forward_logits(ids, mask, lora={"layers": {}})
    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        enc.params.forward_hidden(ids, mask, part=object())
    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        encoder.DeepseekV2BiSparse(enc.params, enc.config, lora={})
    from scaling_retriever_tpu_torch.parallel import partitioning

    with pytest.raises(NotImplementedError, match="DeepSeek-V2"):
        partitioning.apply_shardings(enc.params, {})


def test_eager_passes_open_the_layer_spans_and_read_rope_once(enc):
    ids, mask = _left_padded(_texts())
    rope = enc.params.rope
    rope.built.clear()
    enc.encode(ids, mask)
    first = dict(rope.built)
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        enc.encode(ids, mask)
    recs = profiling.spans()
    profiling.reset_spans()
    # one build, at the first encode; the second reads the same tables
    key = (ids.shape[1], torch.device("cpu"))
    assert list(first) == list(rope.built) == [key]
    assert rope.built[key] is first[key]
    for name, layers in (("encoder.mla", [0, 1, 2]), ("encoder.moe", [1, 2])):
        got = [r for r in recs if r[0] == name]
        assert [r[5]["layer"] for r in got] == layers
        assert all(r[5]["tokens"] == ids.size for r in got)


def test_flop_and_byte_counts_at_the_published_widths():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    m = run.load_json(run.ROOT, run.config_entry(
        bench, "deepseek-v2-lite")["file"])["model"]
    assert arch.moe_layers(m) == 26
    assert arch.expert_ops(m, 1) == 103809024.0
    assert arch.expert_ops(m, 3136) == 325545099264.0
    assert arch.expert_bytes(m, 0) == 1107296256.0
    assert arch.expert_bytes(m, 3136) == 1261436928.0
    # ~4.90 GFLOP a token: 2.70 of it the routed experts
    assert arch.encode_flops(m, 1) == 4902893568.0
    assert arch.encode_flops(m, 56) == 275413598208.0
    assert 26 * arch.expert_ops(m, 1) / arch.encode_flops(m, 1) == \
        pytest.approx(0.5505, abs=1e-4)


class _Trace:
    def __init__(self, window, device):
        self.window, self.device = window, device


def _rec(device, graphs):
    return {"trace": _Trace((0, 10_000_000_000), device), "graphs": graphs,
            "model": run.load_json(run.ROOT, "retrieval_bench", "configs",
                                   "deepseek-v2-lite.json")["model"]}


def _reader(name):
    return run.load_file(os.path.join(run.ROOT, "retrieval_bench", "metrics",
                                      f"{name}.py"), f"t_{name}")


def test_the_routed_expert_readers_on_hand_made_records(monkeypatch):
    from retrieval_bench.metrics import program_spans

    monkeypatch.setattr(program_spans, "records",
                        lambda rec, match: rec["graphs"] or None)
    roof, share = (_reader("encoder.moe_roofline.text"),
                   _reader("encoder.moe_share.text"))
    m = _rec([], [])["model"]
    graphs = [("encoder.graph", 1_000, 2_000, 1, "frontend.dispatch",
               {"width": 64, "rung": 64, "tokens": 3136}),
              ("encoder.graph", 3_000, 4_000, 1, "frontend.dispatch",
               {"width": 8, "rung": 64, "tokens": 400}),
              # outside the window: not counted
              ("encoder.graph", 11_000_000_000, 11_000_000_100, 1, "x",
               {"width": 8, "rung": 64, "tokens": 400})]
    s = 1_000_000_000
    device = [(0, s, "void moe_expert_up_kernel(...)", 1),
              (s, 2 * s, "void moe_expert_down_kernel(...)", 2),
              (2 * s, 3 * s, "void moe_route_kernel(...)", 3),
              (3 * s, 5 * s, "nvjet_tst_192x128", 4),
              (7 * s, 8 * s, "void moe_combine_kernel(...)", 5)]
    least = 26 * sum(max(arch.expert_ops(m, t) / flops.BF16_OPS_PER_S,
                         arch.expert_bytes(m, t) / flops.HBM_BYTES_PER_S)
                     for t in (3136, 400))
    rec = _rec(device, graphs)
    assert roof.read(rec) == pytest.approx(100.0 * least / 2.0, rel=1e-12)
    # 4 of the 6 busy seconds in moe_ kernels
    assert share.read(rec) == pytest.approx(100.0 * 4 / 6, rel=1e-12)
    no_moe = [d for d in device if "moe_" not in d[2]]
    assert roof.read(_rec(no_moe, graphs)) is None
    assert share.read(_rec(no_moe, graphs)) is None
    assert roof.read(_rec(device, [])) is None
    untagged = [g[:5] + ({"width": 8, "rung": 64},) for g in graphs]
    assert roof.read(_rec(device, untagged)) is None
    assert share.read({"trace": None}) is None


def test_a_replay_counts_its_real_positions_only_while_traced():
    from scaling_retriever_tpu_torch.models import tile_graphs

    class Graph:
        def replay(self):
            pass

    static = torch.zeros((2, 4), dtype=torch.int32)
    tile = tile_graphs._Tile(Graph(), static, static.clone(),
                             (torch.zeros(2),))
    mask = np.array([[0, 1, 1, 1], [0, 0, 1, 1]], np.int32)
    profiling.reset_spans()
    tile.replay(np.zeros_like(mask), mask)      # no profiler: no record
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tile.replay(np.zeros_like(mask), mask)
    recs = [r for r in profiling.spans() if r[0] == "encoder.graph"]
    profiling.reset_spans()
    assert [r[5] for r in recs] == [{"width": 2, "rung": 4, "tokens": 5}]


def test_the_cell_runs_through_the_harness_at_a_tiny_size():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, conf, mix = run.cell_spec(bench, CELL)
    assert conf["model"]["model_type"] == "deepseek_v2"
    mix = copy.deepcopy(mix)
    mix.update(rate_qps=60, t_sparse=16, sample=6, word_bank=256)
    lim = run.load_json(run.ROOT, "retrieval_bench", "limits",
                        f"{CELL}.json")["limits"]
    res = run.run_cell(bench, CELL, SEED, 0.3, True, torch.device("cpu"),
                       conf=TINY_CONF, traffic=mix, limits=lim)
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == set(lim)
    assert res["metrics"]["mfu.text"]["value"] > 0
    # no graph replays and no kernels on the CPU: the readers find nothing
    assert "encoder.moe_roofline.text" not in res["metrics"]
    assert "encoder.moe_share.text" not in res["metrics"]
    assert res["out"]["record"]["model"] == TINY
