"""Kimi Delta Attention's kernel (``csrc/kda.cu`` through ``ops/kda.py``:
the convolutions, norms, decay, recurrence and gated output norm of a KDA
layer) against its plain steps, on the card, at Kimi-Linear's widths (32
heads of 128) and the serving tiles (8 and 64 texts of 64 positions), at
lengths that leave a partial staging chunk, with strong and weak decay
and a left-padded text; and a tiny Kimi-Linear encoder's tiles replayed
from CUDA graphs against the same tiles run eagerly.

Every test is marked ``cuda`` and skips on a host without an NVIDIA GPU;
this file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kda_cuda.py
"""

import numpy as np
import pytest
import torch

from scaling_retriever_tpu_torch.ops import cuda_lib, kda

pytestmark = pytest.mark.cuda

H, D = 32, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(b, s, dev, seed, decay=1.0):
    """A layer's kernel inputs as ``DeltaAttention`` hands them over: the
    raw projections, f and the gate in bf16, beta from a sigmoid, the
    first text's first half pads, convolutions of PyTorch's default range,
    ``A_log`` as fla initialises it (times ``decay``), dt_bias the inverse
    softplus of 1e-3 .. 1e-1."""
    w = H * D
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q, k, v, f, gate = (rand(b, s, w).to(torch.bfloat16) for _ in range(5))
    beta = torch.sigmoid(rand(b, s, H))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0, : s // 2] = 0
    beta = beta * mask[:, :, None]
    convs = [(rand(w, 1, 4) * 0.3).to(torch.bfloat16) for _ in range(3)]
    a_log = torch.log(1 + 15 * torch.rand(1, 1, H, 1, generator=g,
                                          device=dev)) + float(np.log(decay))
    dt = torch.exp(np.log(1e-3) + torch.rand(w, generator=g, device=dev)
                   * np.log(100.0))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    o_norm = (1 + 0.05 * rand(D)).to(torch.bfloat16)
    return (q, k, v, f, beta, gate, mask, *convs, a_log, dt_bias, o_norm,
            1e-5)


def plain_f32(args) -> torch.Tensor:
    """The plain steps over the same inputs with no rounding of the output:
    the bf16 tensors (q, k, v, f, the gate) widened to float32, TF32 off."""
    wide = [t.float() if i < 6 else t for i, t in enumerate(args)]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return kda.delta_attention_plain(*wide)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of the bf16 ``got`` over its element's limit
    against the float32 ``want``: 2**-8 |want| (the most one bf16
    rounding of the output moves it) plus 2**-12 of want's root mean
    square, the room for float32 sums in another order at the layer's
    scale. At most 1 where every element is within its limit."""
    want = want.float()
    floor = 2 ** -12 * want.square().mean().sqrt()
    err = (got.float() - want).abs()
    return (err / (2 ** -8 * want.abs() + floor)).max().item()


@pytest.mark.parametrize("b,s,decay", [(64, 64, 1.0), (8, 64, 1.0),
                                       (8, 64, 0.01), (8, 64, 100.0),
                                       (3, 37, 1.0), (2, 1, 1.0)])
def test_the_kernel_matches_the_plain_steps(cuda, b, s, decay):
    """Element by element (``excess``): a state kept in bf16 between
    positions reads over its limit at the serving tiles' 64 positions."""
    args = _inputs(b, s, cuda, 10 * b + s, decay)
    before = cuda_lib.LAUNCHES["kda"]
    got = kda.delta_attention(*args)
    assert cuda_lib.LAUNCHES["kda"] == before + 1
    worst = excess(got, plain_f32(args))
    assert worst <= 1.0, worst
    assert not got[0, : s // 2].any()       # a left pad's state stays 0
    # the same sums in the same order: the same bits on every launch
    assert torch.equal(kda.delta_attention(*args), got)


def test_a_captured_graph_serves_new_inputs(cuda):
    args = _inputs(8, 64, cuda, 3)
    kda.delta_attention(*args)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = kda.delta_attention(*args)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (4, 5):
        for dst, src in zip(args[:13], _inputs(8, 64, cuda, seed)):
            dst.copy_(src)
        graph.replay()
        assert torch.equal(out, kda.delta_attention(*args))


def test_other_head_dims_are_refused(cuda):
    args = list(_inputs(2, 8, cuda, 1))
    args[10] = torch.zeros(64, 1, 1, 1, device=cuda)     # 64 heads of 64
    with pytest.raises(ValueError, match="heads of 128"):
        kda.delta_attention(*args)


class _EchoServer:
    """Stands in for the retrieval server: a request's result is its rep."""

    backend = None

    def submit(self, rep, topk=None):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(rep)
        return fut


def _tiny_kimi(dev, vocab=20000):
    """A Kimi-Linear-shaped encoder at widths the kernels take: hidden
    256, KDA layers of 2 heads of 128, NoPE MLA, one period (KDA, KDA,
    KDA, MLA) whose first layer is dense, then experts 4-11 held of the
    router's 16, top 4, one shared."""
    from scaling_retriever_tpu_torch.models import encoder, kimi_linear
    from scaling_retriever_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_hf_config({
        "model_type": "kimi_linear", "vocab_size": vocab,
        "hidden_size": 256, "intermediate_size": 512,
        "num_hidden_layers": 4, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 64, "q_lora_rank": None,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
        "mla_use_nope": True,
        "linear_attn_config": {"full_attn_layers": [4],
                               "kda_layers": [1, 2, 3], "head_dim": 128,
                               "num_heads": 2, "short_conv_kernel_size": 4},
        "num_experts": 8, "num_experts_per_token": 4,
        "num_shared_experts": 1, "moe_intermediate_size": 128,
        "first_k_dense_replace": 1, "moe_layer_freq": 1,
        "moe_renormalize": True, "moe_router_activation_func": "sigmoid",
        "num_expert_group": 1, "topk_group": 1,
        "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False,
        "expert_share": {"router_experts": 16, "first_held": 4}},
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = kimi_linear.empty_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if p.dim() == 1 and "bias" not in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.3 if "conv" in name else 0.02, generator=g)
    return encoder.KimiLinearBiSparse(params, cfg)


def test_graphed_kimi_tiles_equal_eager_tiles(cuda):
    """At each (width, rung) of a two-width, two-rung ladder a replayed
    tile's (terms, vals) equal the eager tile's bit for bit: the KDA
    kernel and the held share's expert kernels run inside the graph, and
    each eager tile launches the KDA kernel once a KDA layer."""
    from scaling_retriever_tpu_torch.benches.common import StandInTokenizer
    from scaling_retriever_tpu_torch.models import tile_graphs
    from scaling_retriever_tpu_torch.serving.text_frontend import (
        QueryEncoderFrontend, make_encode_fn, make_encode_fn_handoff)

    t_sparse = 16
    model = _tiny_kimi(cuda)
    vocab = model.vocab_size
    tok = StandInTokenizer(vocab, (8, 16))
    fe = QueryEncoderFrontend(_EchoServer(), make_encode_fn(model, t_sparse),
                              tok, widths=(4, 8), t_sparse=t_sparse)
    rng = np.random.default_rng(5)
    texts = [" ".join(f"w{x}" for x in rng.integers(1, vocab,
                                                     rng.integers(3, 15)))
             for _ in range(16)]
    fe.warmup(texts[:4], passes=2)
    assert len(model.tile_graphs) == 4
    encode = make_encode_fn_handoff(model, t_sparse)
    model.params.reset_expert_load()
    for width in (4, 8):
        for rung in (8, 16):
            tiles = [tok(texts[i:i + width], length=rung)
                     for i in (0, width)]
            n0 = tile_graphs.replays()
            with torch.no_grad():
                got = [encode(*t) for t in tiles]
            assert tile_graphs.replays() == n0 + 2
            launched = cuda_lib.LAUNCHES["kda"]
            with torch.enable_grad():
                want = [encode(*t) for t in tiles]
            assert cuda_lib.LAUNCHES["kda"] - launched == 2 * 3
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
            assert int((got[0][1] > 0).sum()) > 0
    # every slot of every tile counted: held or absent
    load, absent = model.params.expert_load(), model.params.expert_absent()
    slots = 2 * 2 * (4 * 8 + 4 * 16 + 8 * 8 + 8 * 16) * 4
    assert int(load.sum() + absent.sum()) == 3 * slots
    assert int(absent.sum()) > 0 and int(load.sum()) > 0
