"""The attention block's kernel (``csrc/attention.cu`` through
``ops/attention.py`` ``rope_attention``) against its plain version, the
composition of ``apply_rope`` and ``attention``, on the card: at Qwen2's
(12 / 2 heads of 128, large q/k/v biases upstream), Mistral's (32 / 8 of
128) and Llama-3.2-1B's (32 / 8 of 64) head layouts, at the serving rungs
16 and 64 (one key block) and at 200 positions (four key blocks, the last
ragged), under left-padded masks with a row of one real token and a row
of none; every other head dim the kernel takes; the split of a group's
query tiles over blocks; and under a captured CUDA graph.

Every test is marked ``cuda`` and skips on a host without an NVIDIA GPU;
this file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_cuda.py
"""

import pytest
import torch

from scaling_retriever_tpu_torch.models import llama
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.ops import attention as att
from scaling_retriever_tpu_torch.ops import cuda_lib

pytestmark = pytest.mark.cuda

# heads, KV heads, head dim, rope theta
LAYOUTS = {"qwen2": (12, 2, 128, 1e6), "mistral": (32, 8, 128, 1e4),
           "llama-1b": (32, 8, 64, 5e5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(layout, b: int, s: int, dev, seed: int = 0):
    """bf16 q, k, v as the projections give them (Qwen2's with a bias
    added a dimension), the rope tables and the bias of a left-padded
    mask: row 0 holds one real token, row 1 none, row 2 all, the others
    1 to s. ``layout`` names one of ``LAYOUTS`` or is such a tuple."""
    n_q, n_kv, hd, theta = LAYOUTS.get(layout, layout)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, n_q, hd, generator=g, device=dev)
    k = torch.randn(b, s, n_kv, hd, generator=g, device=dev)
    v = torch.randn(b, s, n_kv, hd, generator=g, device=dev)
    if layout == "qwen2":
        q += 2 * torch.randn(n_q, hd, generator=g, device=dev)
        k += 2 * torch.randn(n_kv, hd, generator=g, device=dev)
        v += torch.randn(n_kv, hd, generator=g, device=dev)
    cfg = ModelConfig(num_attention_heads=n_q, num_key_value_heads=n_kv,
                      hidden_size=n_q * hd, rope_theta=theta)
    cos, sin = llama.rope_cos_sin(cfg, s, dev)
    real = torch.randint(1, s + 1, (b,), generator=g, device=dev)
    real[0], real[1], real[2] = 1, 0, s
    mask = (torch.arange(s, device=dev)[None, :] >= s - real[:, None]).int()
    bf = torch.bfloat16
    return q.to(bf), k.to(bf), v.to(bf), cos, sin, llama.padding_bias(mask)


def _errors(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item(), want.float().abs().mean().item()


@pytest.mark.parametrize("s", [16, 64, 200])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_matches_plain(cuda, layout, s):
    """Against the plain version on the card: the roped operands are the
    same bits, and the logits, softmax sum and P.V are float32 sums in
    another order, so an output differs by a bf16 rounding or a
    probability's; and a second launch gives the same bits."""
    b = 64 if s <= 64 else 8
    q, k, v, cos, sin, bias = _inputs(layout, b, s, cuda, seed=s)
    before = cuda_lib.LAUNCHES["rope_attention"]
    got = att.rope_attention(q, k, v, cos, sin, bias)
    want = att.rope_attention_plain(q, k, v, cos, sin, bias)
    again = att.rope_attention(q, k, v, cos, sin, bias)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["rope_attention"] == before + 2
    assert torch.equal(got, again)
    top, mean, scale = _errors(got, want)
    print(layout, s, "max", top, "mean", mean, "mean |want|", scale)
    assert top <= 2 ** -6 * v.float().abs().max().item(), (top, mean)
    assert mean <= 2 ** -10 * scale, (top, mean, scale)
    # a fault the bound sees: k left unroped
    n_q, n_kv, hd, _ = LAYOUTS[layout]
    unroped = att.attention(llama.apply_rope(q, cos, sin), k, v, bias)
    assert _errors(unroped, want)[1] > 16 * 2 ** -10 * scale


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_real_token_serves_its_value_row(cuda, layout):
    """A row with one real key: every query's softmax is 1 on that key and
    exactly 0 elsewhere, so each head's output is its KV head's v row,
    bit for bit (GQA by index). A row with none: a uniform softmax, as the
    plain version's."""
    n_q, n_kv, hd, _ = LAYOUTS[layout]
    q, k, v, cos, sin, bias = _inputs(layout, 4, 64, cuda, seed=1)
    got = att.rope_attention(q, k, v, cos, sin, bias)
    want = att.rope_attention_plain(q, k, v, cos, sin, bias)
    torch.cuda.synchronize()
    heads = got.view(4, 64, n_q, hd)
    last = v[0, -1].repeat_interleave(n_q // n_kv, dim=0)
    assert torch.equal(heads[0], last[None].expand(64, n_q, hd))
    top, _, _ = _errors(got[1], want[1])
    assert top <= 2 ** -6 * v.float().abs().max().item()


@pytest.mark.parametrize("layout,b,s", [("mistral", 64, 64),
                                        ("qwen2", 8, 16),
                                        ("llama-1b", 4, 200)])
def test_captured_graph_replays_the_eager_launch(cuda, layout, b, s):
    """One launch captured, then replayed over other inputs copied into
    its static ones: each replay equals an eager launch bit for bit."""
    static = _inputs(layout, b, s, cuda, seed=2)
    att.rope_attention(*static)                      # eager first
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    before = cuda_lib.LAUNCHES["rope_attention"]
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = att.rope_attention(*static)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert cuda_lib.LAUNCHES["rope_attention"] == before + 1
    for seed in (3, 4):
        fresh = _inputs(layout, b, s, cuda, seed=seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        want = att.rope_attention(*fresh)
        torch.cuda.synchronize()
        assert torch.equal(out, want), seed


@pytest.mark.parametrize("hd", att.HEAD_DIMS)
def test_every_head_dim_instance_matches_plain(cuda, hd):
    """Each of the kernel's instances (every multiple of 16 up to 128) at
    one key block and at three (the last ragged), GQA 3:1, against the
    plain version as in ``test_kernel_matches_plain``."""
    for s in (24, 150):
        q, k, v, cos, sin, bias = _inputs((6, 2, hd, 1e4), 6, s, cuda,
                                          seed=hd)
        got = att.rope_attention(q, k, v, cos, sin, bias)
        want = att.rope_attention_plain(q, k, v, cos, sin, bias)
        torch.cuda.synchronize()
        assert got.shape == (6, s, 6 * hd)
        top, mean, scale = _errors(got, want)
        assert top <= 2 ** -6 * v.float().abs().max().item(), (hd, s, top)
        assert mean <= 2 ** -10 * scale, (hd, s, mean, scale)


@pytest.mark.parametrize("batch,seq,n_q,n_kv,split", [
    (64, 64, 32, 8, 1),     # Mistral's 64 x 64 tile: 512 groups of 16
    (64, 16, 12, 2, 1),     # Qwen2's 64 x 16: 128 groups of 6 tiles
    (8, 16, 12, 2, 1),      # Qwen2's 8 x 16: fewer tiles than warps
    (64, 64, 12, 2, 2),     # Qwen2's 64 x 64: 128 groups of 24 tiles
    (8, 256, 32, 8, 4),     # passages: 64 groups of 64 tiles
    (2, 200, 32, 8, 7),     # 16 groups of 50 tiles, the last block's 2
    (1, 5, 4, 4, 1),        # one tile a group
])
def test_split_fills_the_card_and_leaves_no_block_empty(cuda, batch, seq,
                                                         n_q, n_kv, split):
    """The blocks the C entry splits a group's 16-row query tiles over, for
    head dim 128 on an H100 SXM (132 SMs, two blocks of 8 warps resident
    an SM): every block runs at once, or a block takes a whole group, and
    no block is left empty."""
    import ctypes

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms != 132:
        pytest.skip(f"the split is pinned for 132 SMs, the card has {sms}")
    got = ctypes.c_int32(0)
    with torch.cuda.device(cuda):
        rc = cuda_lib.library().srt_rope_attention_split(
            batch, seq, n_q, n_kv, 128, ctypes.byref(got))
    assert rc == 0
    assert got.value == split
    tiles = -(-(n_q // n_kv) * seq // 16)
    per = -(-tiles // split)                 # as csrc/attention.cu counts
    assert (split - 1) * per < tiles <= split * per
    assert batch * n_kv * split <= 2 * 132 or split == 1


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, cos, sin, bias = _inputs("mistral", 4, 16, cuda)
    with pytest.raises(TypeError):
        att.rope_attention(q.float(), k, v, cos, sin, bias)
    with pytest.raises(ValueError):
        att.rope_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, v, cos, sin, bias)
    for hd in (8, 120):
        with pytest.raises(ValueError, match="multiples of 16"):
            att.rope_attention(
                q[..., :hd].contiguous(), k[..., :hd].contiguous(),
                v[..., :hd].contiguous(), cos[:, :hd].contiguous(),
                sin[:, :hd].contiguous(), bias)
