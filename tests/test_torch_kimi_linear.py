"""Kimi-Linear as a sparse encoder (``models/kimi_linear.py``,
``ops/kda.py``, the held share of ``ops/moe.py``) on the CPU, against the
benchmark's plain reference (``retrieval_bench/reference/kimi_linear.py``)
on a tiny configuration of the published shape: hidden 64, KDA and MLA
layers of 4 heads of 16, one period (KDA, KDA, KDA, MLA) whose first
layer has the dense FFN, 16 routed experts of which 8 are held, top 4, one
shared expert. Also the recurrence alone, the sigmoid router, the share
test, pad invariance, the configuration's keys, the loader on an
HF-named checkpoint, and the two KDA readers on hand-made records."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from retrieval_bench import flops, gen, run
from retrieval_bench.archs import kimi_linear as arch
from retrieval_bench.reference import kimi_linear as ref
from retrieval_bench.reference.decoder import rms_norm
from retrieval_bench.tests.helpers import SEED
from scaling_retriever_tpu_torch.models import (deepseek_v2, encoder,
                                                hf_loader, kimi_linear,
                                                safetensors_io)
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import kda, moe
from scaling_retriever_tpu_torch.utils import profiling

CELL = "kimi-linear-48b-a3b.text-long"
F32 = {"dtype": torch.float32, "param_dtype": torch.float32}
# float32 on both sides, summed in other orders (the recurrence's reads,
# the experts by slot rather than by expert, a finite padding bias against
# -inf): ~1e-6 of a rep's largest value at these widths
REP_RTOL = 1e-5

TINY = {"model_type": "kimi_linear", "hidden_size": 64,
        "intermediate_size": 96, "num_hidden_layers": 4,
        "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
        "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "mla_use_nope": True,
        "linear_attn_config": {"full_attn_layers": [4],
                               "kda_layers": [1, 2, 3], "head_dim": 16,
                               "num_heads": 4, "short_conv_kernel_size": 4},
        "num_experts": 8, "num_experts_per_token": 4,
        "num_shared_experts": 1, "moe_intermediate_size": 32,
        "first_k_dense_replace": 1, "moe_layer_freq": 1,
        "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
        "num_expert_group": 1, "topk_group": 1, "use_grouped_topk": True,
        "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5,
        "rope_theta": 10000, "rope_scaling": None, "vocab_size": 512,
        "tie_word_embeddings": False, "hidden_act": "silu",
        "expert_share": {"router_experts": 16, "first_held": 0,
                         "cards": 2}}
TINY_CONF = {"model": TINY, "arch": "kimi_linear",
             "encoder": "KimiLinearBiSparse",
             "index": {"n_docs": 5000, "postings_per_doc": 16}}


def share(first: int = 0, held: int = 8) -> dict:
    """TINY holding experts first .. first + held - 1 of the router's 16;
    held 16 is the uncut layer."""
    m = copy.deepcopy(TINY)
    m["num_experts"] = held
    m["expert_share"] = dict(m["expert_share"], first_held=first)
    if held == 16:
        del m["expert_share"]
    return m


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texts(n: int = 5, seed: int = 3, lo: int = 3, hi: int = 12) -> list:
    rng = np.random.default_rng(seed)
    return [list(rng.integers(2, 512, int(k))) for k in
            rng.integers(lo, hi, n)]


def _padded(toks: list, width: int = 0, length: int = 0,
            left: bool = True) -> tuple:
    s = max(length, max(len(t) for t in toks))
    ids = np.zeros((max(width, len(toks)), s), np.int32)
    mask = np.zeros_like(ids)
    for i, t in enumerate(toks):
        at = slice(s - len(t), s) if left else slice(0, len(t))
        ids[i, at] = t
        mask[i, at] = 1
    return ids, mask


@pytest.fixture(scope="module")
def enc():
    return arch.build_encoder(TINY_CONF, SEED, "cpu", **F32)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_the_port_matches_the_reference_in_float32(enc):
    toks = _texts()
    got = enc.encode(*_padded(toks))
    want = ref.sparse_reps(TINY, SEED, toks, "cpu")
    assert got.shape == want.shape == (len(toks), 512)
    assert _rel(got, want) < REP_RTOL
    assert [layer.is_kda for layer in enc.params.layers] == [
        True, True, True, False]
    assert enc.params.rope is None


def _qkvgb(b=2, s=6, h=3, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g) for _ in range(3))
    gate = -torch.rand(b, s, h, d, generator=g) * 2.0
    beta = torch.rand(b, s, h, generator=g)
    return q, k, v, gate, beta


def test_the_plain_recurrence_matches_the_reference_s_token_loop():
    q, k, v, g, beta = _qkvgb()
    got = kda.recurrence(q, k, v, g, beta)
    want = ref.delta_rule(q, k, v, g, beta)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_the_recurrence_by_hand_over_two_positions():
    """d 2, one head: k_0 = (1, 0), k_1 = (0.6, 0.8) (unit), q the same
    direction as k scaled by 2**-0.5 after its norm."""
    k = torch.tensor([[1.0, 0.0], [0.6, 0.8]]).view(1, 2, 1, 2)
    q = torch.tensor([[3.0, 0.0], [0.0, 2.0]]).view(1, 2, 1, 2)
    v = torch.tensor([[2.0, -1.0], [1.0, 4.0]]).view(1, 2, 1, 2)
    alpha = torch.tensor([[0.5, 0.25], [0.5, 0.5]])
    g = alpha.log().view(1, 2, 1, 2)
    beta = torch.tensor([0.5, 1.0]).view(1, 2, 1)
    got = kda.recurrence(q, k, v, g, beta).view(2, 2)
    eps = kda.NORM_EPS
    kn = k.view(2, 2) / torch.sqrt(torch.tensor(1.0 + eps))
    qn = q.view(2, 2) / torch.sqrt(torch.tensor([[9.0], [4.0]]) + eps)
    qn = qn * 2 ** -0.5
    s1 = 0.5 * torch.outer(kn[0], v.view(2, 2)[0])     # S_0 = 0
    d1 = torch.diag(alpha[1]) @ s1
    s2 = ((torch.eye(2) - 1.0 * torch.outer(kn[1], kn[1])) @ d1
          + 1.0 * torch.outer(kn[1], v.view(2, 2)[1]))
    want = torch.stack([s1.T @ qn[0], s2.T @ qn[1]])
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)
    # by number: o_0 = 0.5 * (k . q) v_0 / sqrt(2)
    assert torch.allclose(got[0], torch.tensor([2.0, -1.0]) * 0.5 * 2 ** -0.5,
                          rtol=1e-5)


def test_the_sigmoid_router_matches_the_reference():
    cfg = ModelConfig.from_hf_config(TINY, **F32)
    w = ref.layer_weights(TINY, SEED, 1, "cpu", torch.float32)
    router = deepseek_v2.Router(cfg)
    with torch.no_grad():
        router.weight.copy_(w["router"])
        router.e_score_correction_bias.copy_(w["bias"])
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(1)) / 8
    got_w, got_ids = router(x)
    want_w, want_ids = ref.route(TINY, w, x)
    assert torch.equal(got_ids.sort(-1).values, want_ids.sort(-1).values)
    assert torch.allclose(got_w.sum(-1), torch.full((40,), 2.446),
                          rtol=1e-6)
    order = got_ids.argsort(-1)
    assert torch.allclose(got_w.gather(-1, order),
                          want_w.gather(-1, want_ids.argsort(-1)), rtol=1e-6)
    # the bias picks, the raw scores weigh
    assert not torch.equal(
        torch.topk(torch.sigmoid(x @ w["router"].T), 4).indices.sort().values,
        got_ids.sort().values)


def test_deepseek_s_softmax_router_is_unchanged_bit_for_bit():
    m = {"model_type": "deepseek_v2", "hidden_size": 32,
         "n_routed_experts": 8, "num_experts_per_tok": 3,
         "routed_scaling_factor": 1.5, "norm_topk_prob": False,
         "q_lora_rank": None}
    router = deepseek_v2.Router(ModelConfig.from_hf_config(m, **F32))
    assert not hasattr(router, "e_score_correction_bias")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        router.weight.copy_(torch.randn(8, 32, generator=g))
    x = torch.randn(20, 32, generator=g)
    w, ids = router(x)
    # HF DeepSeek-V2's MoEGate, as the port had it
    scores = torch.nn.functional.linear(x.float(),
                                        router.weight.float()).softmax(-1)
    want_w, want_ids = torch.topk(scores, 3, dim=-1)
    assert torch.equal(ids, want_ids)
    assert torch.equal(w, want_w * 1.5)


def test_the_held_shares_add_up_to_the_uncut_layer():
    """Layer 1's FFN (MoE) from the port holding experts 0-7 and from it
    holding 8-15, with the shared expert counted once, is the uncut
    reference's layer."""
    x = torch.randn(3, 7, 64, generator=torch.Generator().manual_seed(2))
    outs, absent = [], []
    for first in (0, 8):
        m = share(first)
        cfg = ModelConfig.from_hf_config(m, **F32)
        assert cfg.experts_held == (first, 8) and cfg.n_routed_experts == 16
        layer = deepseek_v2.MoE(cfg)
        w = ref.layer_weights(m, SEED, 1, "cpu")
        with torch.no_grad():
            for name, t in (("gate.weight", "router"),
                            ("gate.e_score_correction_bias", "bias"),
                            ("w_gu", "w_gu"), ("w_d", "w_d"),
                            ("shared.wg.weight", "sg"),
                            ("shared.wu.weight", "su"),
                            ("shared.wd.weight", "sd")):
                layer.get_parameter(name).copy_(w[t])
        load = torch.zeros(8, dtype=torch.int64)
        gone = torch.zeros(1, dtype=torch.int64)
        with torch.no_grad():
            outs.append(layer(x, load, gone))
        assert int(load.sum() + gone.sum()) == 3 * 7 * 4
        absent.append(int(gone))
    uncut = share(0, 16)
    w = {k: v.float() for k, v in
         ref.layer_weights(uncut, SEED, 1, "cpu").items()}
    shared = ref.swiglu(x.view(-1, 64), w["sg"], w["su"], w["sd"],
                        "f32").view(x.shape)
    want = ref.experts(uncut, w, x, "f32")
    got = outs[0] + outs[1] - shared
    assert _rel(got, want) < 1e-5
    assert absent[0] + absent[1] == 3 * 7 * 4
    # the reference's own share leaves the absent experts out alike
    part = ref.experts(share(8), {k: v.float() for k, v in
                                  ref.layer_weights(share(8), SEED, 1,
                                                    "cpu").items()},
                       x, "f32")
    assert _rel(part, outs[1]) < 1e-5


def test_the_held_share_routes_and_combines_only_present_slots():
    ids = torch.tensor([[0, 5, 9], [12, 3, 8], [15, 14, 13]])
    load = torch.zeros(8, dtype=torch.int64)
    absent = torch.zeros(1, dtype=torch.int64)
    r = moe.route(ids, 8, load, first=8, absent=absent)
    # held local ids: slot 2 -> 1, 3 -> 4, 5 -> 0, 6 -> 7, 7 -> 6, 8 -> 5
    assert r.offsets.tolist() == [0, 1, 2, 2, 2, 3, 4, 5, 6]
    assert r.inv.tolist() == [-1, -1, 1, 2, -1, 0, 5, 4, 3]
    assert r.order[:6].tolist() == [5, 2, 3, 8, 7, 6]
    assert load.tolist() == [1, 1, 0, 0, 1, 1, 1, 1]
    assert int(absent) == 3
    y = torch.arange(9 * 2, dtype=torch.float32).view(9, 2)
    out = moe.combine(y, r, torch.zeros(3, 2), 3)
    assert out.tolist() == [[2, 3], [4 + 0, 5 + 1],
                            [10 + 8 + 6, 11 + 9 + 7]]


@pytest.mark.parametrize("width", [8, 64])
@pytest.mark.parametrize("left", [True, False])
def test_a_text_reads_alike_alone_and_in_a_padded_tile(enc, width, left):
    toks = _texts(5, seed=width, lo=2, hi=9)
    alone = torch.cat([enc.encode(*_padded([t])) for t in toks])
    tiled = enc.encode(*_padded(toks, width=width, length=16, left=left))
    assert _rel(tiled[:len(toks)], alone) < 1e-5


@pytest.mark.parametrize("key,value,named", [
    ("q_lora_rank", 1536, "q_lora_rank"),
    ("mla_use_nope", False, "mla_use_nope"),
    ("moe_router_activation_func", "softmax", "moe_router_activation_func"),
    ("num_expert_group", 4, "num_expert_group"),
    ("mla_use_output_gate", True, "mla_use_output_gate"),
    ("attn_res_block_size", 12, "attn_res_block_size"),
    ("hidden_act", "situ", "hidden_act"),
    ("linear_attn_config", {"full_attn_layers": [4], "kda_layers": [1, 2, 3],
                            "head_dim": 16, "num_heads": 4,
                            "short_conv_kernel_size": 4,
                            "gate_lower_bound": -5},
     "gate_lower_bound"),
    ("linear_attn_config", {"full_attn_layers": [4], "kda_layers": [1, 2],
                            "head_dim": 16, "num_heads": 4,
                            "short_conv_kernel_size": 4},
     "linear_attn_config")])
def test_an_unimplemented_setting_raises_naming_its_key(key, value, named):
    with pytest.raises(NotImplementedError, match=named):
        ModelConfig.from_hf_config(dict(TINY, **{key: value}))


def test_the_catalog_row_s_keys_read_into_the_config():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    conf = run.load_json(run.ROOT, run.config_entry(
        bench, "kimi-linear-48b-a3b")["file"])
    cfg = ModelConfig.from_hf_config(conf["model"])
    assert (cfg.n_routed_experts, cfg.experts_held, cfg.num_experts_per_tok,
            cfg.n_shared_experts, cfg.norm_topk_prob, cfg.scoring_func,
            cfg.topk_method, cfg.routed_scaling_factor) == (
        256, (0, 64), 8, 1, True, "sigmoid", "noaux_tc", 2.446)
    assert [i for i in range(27) if not cfg.is_kda_layer(i)] == [
        3, 7, 11, 15, 19, 23, 26]
    assert cfg.mla_use_nope and cfg.experts_here == 64
    assert all(cfg.is_moe_layer(i) for i in range(1, 27))
    assert not cfg.is_moe_layer(0)
    # the file's top level is the source's config as published, but the
    # experts held
    top = {k: v for k, v in conf.items() if k in conf["model"]}
    assert top == conf["model"]
    assert conf["reduced"] == ["num_experts"]


def _hf_named(m: dict, seed: int, first: int = 0) -> dict:
    """The benchmark's weights under HF Kimi-Linear's names, the held
    experts numbered from ``first`` (the others are left out, as a card's
    share of a checkpoint would leave them)."""
    emb = gen.embed_weights(m, seed, "cpu")
    out = {"model.embed_tokens.weight": emb["embed"],
           "model.norm.weight": emb["final_norm"],
           "lm_head.weight": gen.head_weight(m, seed, "cpu")}
    sa = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj",
          "q_conv": "q_conv1d", "k_conv": "k_conv1d", "v_conv": "v_conv1d",
          "wfa": "f_a_proj", "wfb": "f_b_proj", "wb": "b_proj",
          "wga": "g_a_proj", "wgb": "g_b_proj", "o_norm": "o_norm",
          "wo": "o_proj", "wkv_a": "kv_a_proj_with_mqa",
          "kv_norm": "kv_a_layernorm", "wkv_b": "kv_b_proj"}
    other = {"input_norm": "input_layernorm",
             "post_attn_norm": "post_attention_layernorm",
             "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
             "wd": "mlp.down_proj", "router": "block_sparse_moe.gate",
             "sg": "block_sparse_moe.shared_experts.gate_proj",
             "su": "block_sparse_moe.shared_experts.up_proj",
             "sd": "block_sparse_moe.shared_experts.down_proj"}
    f = m["moe_intermediate_size"]
    for i in range(m["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, t in ref.layer_weights(m, seed, i, "cpu").items():
            if name in ("A_log", "dt_bias"):
                out[f"{pre}self_attn.{name}"] = t
            elif name == "bgb":
                out[f"{pre}self_attn.g_b_proj.bias"] = t
            elif name == "bias":
                out[f"{pre}block_sparse_moe.gate.e_score_correction_bias"] = t
            elif name in ("w_gu", "w_d"):
                for e in range(t.shape[0]):
                    ex = f"{pre}block_sparse_moe.experts.{first + e}."
                    if name == "w_d":
                        out[ex + "w2.weight"] = t[e]
                    else:
                        out[ex + "w1.weight"] = t[e, :f]
                        out[ex + "w3.weight"] = t[e, f:]
            elif name in sa:
                out[f"{pre}self_attn.{sa[name]}.weight"] = t
            else:
                out[f"{pre}{other[name]}.weight"] = t
    return out


def test_an_hf_named_checkpoint_loads_to_the_same_reps(enc, tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    tensors = _hf_named(TINY, SEED)
    # another card's experts in the file are passed over
    tensors.update({k.replace("experts.0.", "experts.12."): v
                    for k, v in tensors.items() if ".experts.0." in k})
    safetensors_io.save_file(tensors, str(ckpt / "model.safetensors"))
    with open(ckpt / "config.json", "w") as f:
        json.dump(dict(TINY, architectures=["KimiLinearForCausalLM"]), f)
    assert encoder.encoder_class(str(ckpt), "sparse") is \
        encoder.KimiLinearBiSparse
    assert encoder.encoder_class(str(ckpt), "dense") is \
        encoder.KimiLinearBiDense
    loaded = encoder.load_encoder(str(ckpt), "sparse", device="cpu", **F32)
    assert isinstance(loaded.params, kimi_linear.KimiLinearBiForMNTP)
    ids, mask = _padded(_texts())
    assert torch.equal(loaded.encode(ids, mask), enc.encode(ids, mask))
    with pytest.raises(NotImplementedError, match="Kimi-Linear"):
        loaded.save_pretrained(str(tmp_path / "again"))
    assert not (tmp_path / "again").exists()
    del tensors["model.layers.2.self_attn.dt_bias"]
    with pytest.raises(ValueError, match="lacks 1 tensors"):
        hf_loader.params_from_hf_tensors(
            tensors, ModelConfig.from_hf_config(TINY, **F32), "cpu")


def test_training_and_sharding_raise_naming_the_architecture(enc):
    ids, mask = (torch.as_tensor(a) for a in _padded(_texts()))
    with pytest.raises(NotImplementedError, match="Kimi-Linear"):
        enc.params.forward_logits(ids, mask, lora={"layers": {}})
    with pytest.raises(NotImplementedError, match="Kimi-Linear"):
        enc.params.forward_hidden(ids, mask, part=object())
    with pytest.raises(NotImplementedError, match="Kimi-Linear"):
        encoder.KimiLinearBiSparse(enc.params, enc.config, lora={})
    from scaling_retriever_tpu_torch.parallel import partitioning

    with pytest.raises(NotImplementedError, match="Kimi-Linear"):
        partitioning.apply_shardings(enc.params, {})


def test_eager_passes_open_the_layer_spans_and_count_the_slots(enc):
    ids, mask = _padded(_texts())
    enc.params.reset_expert_load()
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        enc.encode(ids, mask)
    recs = profiling.spans()
    profiling.reset_spans()
    for name, layers in (("encoder.kda", [0, 1, 2]), ("encoder.mla", [3]),
                         ("encoder.moe", [1, 2, 3])):
        got = [r for r in recs if r[0] == name]
        assert [r[5]["layer"] for r in got] == layers
        assert all(r[5]["tokens"] == ids.size for r in got)
    load, absent = enc.params.expert_load(), enc.params.expert_absent()
    assert load.shape == (3, 8) and absent.shape == (3,)
    assert (load.sum(1) + absent == ids.size * 4).all()
    enc.params.reset_expert_load()
    assert int(enc.params.expert_absent().sum()) == 0


def test_flop_and_byte_counts_at_the_published_widths():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    m = run.load_json(run.ROOT, run.config_entry(
        bench, "kimi-linear-48b-a3b")["file"])["model"]
    assert arch.kda_layers(m) == 20
    # 3 multiply-adds a state entry: 2 * 3 * 128**2 * 32 a token
    assert arch.kda_ops(m, 1) == 3145728.0
    # q, k, v, o bf16 and g f32 over 4,096 channels, beta f32 over 32
    assert arch.kda_bytes(m, 1) == 4096 * 12 + 128
    assert arch.kda_bytes(m, 4096) == pytest.approx(201.85e6, rel=1e-3)
    # ~4.07 GFLOP a token for this card's share: the attention products
    # add 2 * 7 * 32 * (192 + 128) a token a position
    one = arch.encode_flops(m, 1)
    assert 4.0e9 < one < 4.1e9
    assert arch.encode_flops(m, 56) == pytest.approx(
        56 * one + 2 * 56 * 55 * 7 * 32 * 320, rel=1e-12)


class _Trace:
    def __init__(self, window, device):
        self.window, self.device = window, device


def _rec(device, graphs):
    return {"trace": _Trace((0, 10_000_000_000), device), "graphs": graphs,
            "model": run.load_json(run.ROOT, "retrieval_bench", "configs",
                                   "kimi-linear-48b-a3b.json")["model"]}


def _reader(name):
    return run.load_file(os.path.join(run.ROOT, "retrieval_bench", "metrics",
                                      f"{name}.py"), f"t_{name}")


def test_the_kda_readers_on_hand_made_records(monkeypatch):
    from retrieval_bench.metrics import program_spans

    monkeypatch.setattr(program_spans, "records",
                        lambda rec, match: rec["graphs"] or None)
    roof, share_ = (_reader("encoder.kda_roofline.text"),
                    _reader("encoder.kda_share.text"))
    m = _rec([], [])["model"]
    graphs = [("encoder.graph", 1_000, 2_000, 1, "frontend.dispatch",
               {"width": 64, "rung": 64, "tokens": 3136}),
              ("encoder.graph", 3_000, 4_000, 1, "frontend.dispatch",
               {"width": 8, "rung": 64, "tokens": 400}),
              ("encoder.graph", 11_000_000_000, 11_000_000_100, 1, "x",
               {"width": 8, "rung": 64, "tokens": 400})]
    s = 1_000_000_000
    device = [(0, s, "kda_recurrent_kernel(...)", 1),
              (s, 2 * s, "void moe_route_kernel(...)", 2),
              (3 * s, 4 * s, "nvjet_tst_192x128", 3),
              (5 * s, 6 * s, "kda_recurrent_kernel(...)", 4)]
    least = 20 * sum(max(arch.kda_ops(m, t) / flops.BF16_OPS_PER_S,
                         arch.kda_bytes(m, t) / flops.HBM_BYTES_PER_S)
                     for t in (3136, 400))
    rec = _rec(device, graphs)
    assert roof.read(rec) == pytest.approx(100.0 * least / 2.0, rel=1e-12)
    assert share_.read(rec) == pytest.approx(100.0 * 2 / 4, rel=1e-12)
    no_kda = [d for d in device if "kda_" not in d[2]]
    assert roof.read(_rec(no_kda, graphs)) is None
    assert share_.read(_rec(no_kda, graphs)) is None
    assert roof.read(_rec(device, [])) is None
    assert share_.read({"trace": None}) is None


def test_the_cell_runs_through_the_harness_at_a_tiny_size():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, conf, mix = run.cell_spec(bench, CELL)
    assert conf["model"]["model_type"] == "kimi_linear"
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
    for name in ("encoder.kda_roofline.text", "encoder.kda_share.text",
                 "encoder.moe_share.text"):
        assert name not in res["metrics"]


def test_the_reference_s_gated_norm_and_convolution_by_hand():
    x = torch.arange(1.0, 7.0).view(1, 6, 1)
    w = torch.tensor([[[0.5, 0.0, 0.0, 2.0]]])
    # y_t = 2 x_t + 0.5 x_{t-3}
    want = torch.nn.functional.silu(
        torch.tensor([2.0, 4.0, 6.0, 8.5, 11.0, 13.5])).view(1, 6, 1)
    assert torch.allclose(ref.short_conv(x, w), want)
    assert torch.allclose(kda.short_conv(x, w), want)
    o = torch.tensor([3.0, 4.0])
    assert torch.allclose(rms_norm(o, torch.ones(2), 0.0),
                          o / (12.5 ** 0.5))
