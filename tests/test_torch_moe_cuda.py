"""The routed-expert kernels (``csrc/moe.cu`` through ``ops/moe.py``)
against their plain PyTorch versions, on the card, at DeepSeek-V2-Lite's
widths (hidden 2,048, expert width 1,408, 64 experts, top-6) and the
serving tiles' token counts (8 and 64 texts of 64 positions: about 48
and 384 slots an expert, one row tile of at most 64 rows an expert and
three of 128), under the router's spread, a heavy skew, the serving
tile's pad positions, and experts whose counts sit on a row tile's edge;
and under a captured CUDA graph that serves routings it was not captured
with.

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


def _ids(n: int, g: torch.Generator, dev, routing=None):
    """Top-k ids as the router gives them (k distinct experts a token).
    ``skew`` sends most tokens to experts 0-5 and leaves 40-63 empty;
    ``pad`` routes a quarter of the tokens alike to experts 0-5, as a
    serving tile's pad positions do (each of the six carries n / 4 extra
    slots, the others none); ``edges`` gives expert 0 exactly two row
    tiles of slots, expert 1 one row tile and one slot, and experts 2 and
    3 one row tile and 64 or 65 slots (at 128 rows, a last tile of 64
    rows takes both warpgroups on its rows, one of 65 a warpgroup a
    half)."""
    scores = torch.rand(n, E, generator=g, device=dev)
    if routing == "skew":
        scores[:, :6] += (torch.rand(n, 1, generator=g, device=dev) < 0.9)
        scores[:, 40:] = -1.0
    elif routing == "pad":
        scores[:n // 4, :K] += 2.0
    elif routing == "edges":
        rows = moe.ROW_TILE
        scores[:, :4] = -1.0
        for expert, count in enumerate((2 * rows, rows + 1, rows + 64,
                                        rows + 65)):
            scores[:count, expert] = 2.0
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


@pytest.mark.parametrize("n,routing", [(512, None), (4096, None),
                                       (4096, "skew"), (7, None),
                                       (4096, "pad")])
def test_route_matches_plain(cuda, n, routing):
    g = torch.Generator(device=cuda).manual_seed(n)
    ids = _ids(n, g, cuda, routing)
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


@pytest.mark.parametrize("n,routing", [
    (512, None), (4096, None), (512, "skew"), (4096, "skew"), (512, "pad"),
    (4096, "pad"), (512, "edges"), (4096, "edges"), (7, None)])
def test_expert_products_and_combine_match_plain(cuda, n, routing):
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    ids = _ids(n, g, cuda, routing)
    w = torch.rand(n, K, generator=g, device=cuda) * 0.2
    x = torch.randn(n, H, generator=g, device=cuda).to(torch.bfloat16)
    shared = (torch.randn(n, H, generator=g, device=cuda) * 0.1
              ).to(torch.bfloat16)
    w_gu, w_d = _weights(g, cuda)
    r = moe.route(ids, E)
    up, down = "moe_expert_up", "moe_expert_down"
    before = dict(cuda_lib.LAUNCHES)
    hmid = moe.expert_up(x, r, w_gu, K)
    _close(hmid, moe.expert_up_plain(x, r, w_gu, K), "up")
    y = moe.expert_down(hmid, r, w_d, w)
    _close(y, moe.expert_down_plain(hmid, r, w_d, w), "down")
    assert (cuda_lib.LAUNCHES[up], cuda_lib.LAUNCHES[down]) == (
        before[up] + 1, before[down] + 1)
    # each output is one sum in one order: the same bits on every launch
    assert torch.equal(moe.expert_up(x, r, w_gu, K), hmid)
    assert torch.equal(moe.expert_down(hmid, r, w_d, w), y)
    # the same arithmetic in the same order: bit for bit
    assert torch.equal(moe.combine(y, r, shared, K),
                       moe.combine_plain(y, r, shared, K))
    _close(moe.routed_experts(x, ids, w, w_gu, w_d, shared),
           moe.routed_experts_plain(x, ids, w, w_gu, w_d, shared), "layer")


@pytest.mark.parametrize("n", [512, 4096])
def test_one_captured_graph_serves_every_routing(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(7)
    w_gu, w_d = _weights(g, cuda)
    x = torch.randn(n, H, generator=g, device=cuda).to(torch.bfloat16)
    shared = torch.zeros(n, H, dtype=torch.bfloat16, device=cuda)
    ids = _ids(n, g, cuda)
    w = torch.rand(n, K, generator=g, device=cuda) * 0.2
    load = torch.zeros(E, dtype=torch.int64, device=cuda)
    moe.routed_experts(x, ids, w, w_gu, w_d, shared, load)   # eager first
    key = "moe_expert_up"
    before = cuda_lib.LAUNCHES[key]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = moe.routed_experts(x, ids, w, w_gu, w_d, shared, load)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    assert cuda_lib.LAUNCHES[key] == before + 1     # captured, not run
    load.zero_()
    routings = (None, "skew", "pad", "edges")
    for routing in routings:
        ids.copy_(_ids(n, g, cuda, routing))
        graph.replay()
        want = moe.routed_experts(x, ids, w, w_gu, w_d, shared)
        torch.cuda.synchronize()
        assert torch.equal(out, want), routing
    assert int(load.sum()) == len(routings) * n * K


# Kimi-Linear's expert layer as one card of four holds it: 64 of the
# router's 256 experts (ids 64-127 here), top-8, hidden 2,304, width 1,024
KH, KI, KE, KK, KFIRST = 2304, 1024, 64, 8, 64


def _share_ids(n: int, g: torch.Generator, dev, routing=None):
    """Top-8 of 256 as the router gives them; ``pad`` sends a quarter of
    the tokens alike, half of their experts held here."""
    scores = torch.rand(n, 4 * KE, generator=g, device=dev)
    if routing == "pad":
        scores[:n // 4, KFIRST - 4:KFIRST + 4] += 2.0
    return torch.topk(scores, KK, dim=1).indices


@pytest.mark.parametrize("n,routing", [(512, None), (4096, None),
                                       (4096, "pad"), (7, None)])
def test_a_held_share_routes_and_combines_as_the_plain_path(cuda, n,
                                                            routing):
    """Route, the products and the combine over a held share: present
    slots only (offsets, their order and inverse bit for bit), absent
    slots -1 and counted, and the layer within bf16 roundings of the
    plain path; the combine bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(200 + n)
    ids = _share_ids(n, g, cuda, routing)
    load = torch.zeros(KE, dtype=torch.int64, device=cuda)
    absent = torch.zeros(1, dtype=torch.int64, device=cuda)
    want_load = torch.zeros_like(load)
    want_absent = torch.zeros_like(absent)
    r = moe.route(ids, KE, load, KFIRST, absent)
    p = moe.route_plain(ids, KE, want_load, KFIRST, want_absent)
    present = int(p.offsets[-1])
    assert torch.equal(r.offsets, p.offsets) and torch.equal(r.inv, p.inv)
    assert torch.equal(r.order[:present], p.order[:present])
    assert torch.equal(load, want_load) and torch.equal(absent, want_absent)
    assert int(absent) + present == n * KK and int(absent) > 0
    w = torch.rand(n, KK, generator=g, device=cuda) * 0.2
    x = torch.randn(n, KH, generator=g, device=cuda).to(torch.bfloat16)
    shared = (torch.randn(n, KH, generator=g, device=cuda) * 0.1
              ).to(torch.bfloat16)
    w_gu = (torch.randn(KE, 2 * KI, KH, generator=g, device=cuda) * 0.02
            ).to(torch.bfloat16)
    w_d = (torch.randn(KE, KH, KI, generator=g, device=cuda) * 0.02
           ).to(torch.bfloat16)
    hmid = moe.expert_up(x, r, w_gu, KK)
    _close(hmid[:present], moe.expert_up_plain(x, r, w_gu, KK)[:present],
           "up")
    y = moe.expert_down(hmid, r, w_d, w)
    _close(y[:present], moe.expert_down_plain(hmid, r, w_d, w)[:present],
           "down")
    assert torch.equal(moe.combine(y, r, shared, KK),
                       moe.combine_plain(y, r, shared, KK))
    _close(moe.routed_experts(x, ids, w, w_gu, w_d, shared, first=KFIRST),
           moe.routed_experts_plain(x, ids, w, w_gu, w_d, shared,
                                    first=KFIRST), "layer")
