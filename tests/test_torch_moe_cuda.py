"""The routed-expert kernels (``csrc/moe.cu`` through ``ops/moe.py``)
against their plain PyTorch versions, on the card, at DeepSeek-V2-Lite's
widths (hidden 2,048, expert width 1,408, 64 experts, top-6) and the
serving tiles' token counts (8 and 64 texts of 64 positions), and under a
captured CUDA graph that serves a routing it was not captured with.

Every test is marked ``cuda`` and skips on a host without an NVIDIA GPU;
this file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_moe_cuda.py
"""

import pytest
import torch

from scaling_retriever_tpu_torch.ops import cuda_lib, moe

pytestmark = pytest.mark.cuda

H, I, E, K = 2048, 1408, 64, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ids(n: int, g: torch.Generator, dev, skew: bool = False):
    """Top-k ids as the router gives them (k distinct experts a token);
    ``skew`` sends most tokens to experts 0-5 and leaves 40-63 empty."""
    scores = torch.rand(n, E, generator=g, device=dev)
    if skew:
        scores[:, :6] += (torch.rand(n, 1, generator=g, device=dev) < 0.9)
        scores[:, 40:] = -1.0
    return torch.topk(scores, K, dim=1).indices


def _weights(g, dev):
    w_gu = (torch.randn(E, 2 * I, H, generator=g, device=dev) * 0.02
            ).to(torch.bfloat16)
    w_d = (torch.randn(E, H, I, generator=g, device=dev) * 0.02
           ).to(torch.bfloat16)
    return w_gu, w_d


def _close(got, want, what):
    """bf16 results of float32 sums taken in another order: within two
    bf16 roundings (2 * 2**-8) of the largest value."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert err <= 2 * 2 ** -8 * top, (what, err, top)


@pytest.mark.parametrize("n,skew", [(512, False), (4096, False),
                                    (4096, True), (7, False)])
def test_route_matches_plain(cuda, n, skew):
    g = torch.Generator(device=cuda).manual_seed(n)
    ids = _ids(n, g, cuda, skew)
    load = torch.zeros(E, dtype=torch.int64, device=cuda)
    want_load = torch.zeros(E, dtype=torch.int64, device=cuda)
    before = cuda_lib.LAUNCHES["moe_route"]
    for _ in range(2):
        got = moe.route(ids, E, load)
    want = moe.route_plain(ids, E, want_load)
    assert cuda_lib.LAUNCHES["moe_route"] == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert torch.equal(load, 2 * want_load)


@pytest.mark.parametrize("n,skew", [(512, False), (4096, False),
                                    (512, True)])
def test_expert_products_and_combine_match_plain(cuda, n, skew):
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    ids = _ids(n, g, cuda, skew)
    w = torch.rand(n, K, generator=g, device=cuda) * 0.2
    x = torch.randn(n, H, generator=g, device=cuda).to(torch.bfloat16)
    shared = (torch.randn(n, H, generator=g, device=cuda) * 0.1
              ).to(torch.bfloat16)
    w_gu, w_d = _weights(g, cuda)
    r = moe.route(ids, E)
    hmid = moe.expert_up(x, r, w_gu, K)
    _close(hmid, moe.expert_up_plain(x, r, w_gu, K), "up")
    y = moe.expert_down(hmid, r, w_d, w)
    _close(y, moe.expert_down_plain(hmid, r, w_d, w), "down")
    # the same arithmetic in the same order: bit for bit
    assert torch.equal(moe.combine(y, r, shared, K),
                       moe.combine_plain(y, r, shared, K))
    _close(moe.routed_experts(x, ids, w, w_gu, w_d, shared),
           moe.routed_experts_plain(x, ids, w, w_gu, w_d, shared), "layer")


def test_one_captured_graph_serves_every_routing(cuda):
    n = 512
    g = torch.Generator(device=cuda).manual_seed(7)
    w_gu, w_d = _weights(g, cuda)
    x = torch.randn(n, H, generator=g, device=cuda).to(torch.bfloat16)
    shared = torch.zeros(n, H, dtype=torch.bfloat16, device=cuda)
    ids = _ids(n, g, cuda)
    w = torch.rand(n, K, generator=g, device=cuda) * 0.2
    load = torch.zeros(E, dtype=torch.int64, device=cuda)
    moe.routed_experts(x, ids, w, w_gu, w_d, shared, load)   # eager first
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = moe.routed_experts(x, ids, w, w_gu, w_d, shared, load)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    load.zero_()
    for skew in (False, True):
        ids.copy_(_ids(n, g, cuda, skew))
        graph.replay()
        want = moe.routed_experts(x, ids, w, w_gu, w_d, shared)
        torch.cuda.synchronize()
        assert torch.equal(out, want), skew
    assert int(load.sum()) == 2 * n * K
