"""The Kimi-Linear arch module: a checkout whose port lacks the model ends
the run at ``run.load_arch``, and the KDA and held-share expert counts
that its readers divide by agree with a count by hand."""

from __future__ import annotations

import importlib

import pytest
import torch

from retrieval_bench import run
from retrieval_bench.tests.test_rb_archs import _bench, _copy


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_port_without_kimi_linear_ends_the_run_at_its_arch(tmp_path):
    """The Kimi-Linear arch ends a run at once, naming the port's module,
    where the checkout's port has none (a tree from before it)."""
    root, _ = _copy(tmp_path, {})
    bench = _bench()
    cell = "kimi-linear-48b-a3b.text-long"
    wl, conf, traffic = run.cell_spec(bench, cell, root)
    kind = importlib.import_module(f"retrieval_bench.kinds.{traffic['kind']}")
    with pytest.raises(SystemExit, match="models/kimi_linear.py"):
        run.load_arch(root, run.config_entry(bench, wl["config"]), conf,
                      kind)
    arch = run.load_arch(run.ROOT, run.config_entry(bench, wl["config"]),
                         conf, kind)
    for name in ("kda_ops", "kda_bytes", "kda_layers", "moe_layers",
                 "expert_ops", "expert_bytes", *kind.ARCH):
        assert callable(getattr(arch, name)), name
    train = importlib.import_module("retrieval_bench.kinds.train")
    with pytest.raises(SystemExit, match="defines no train_flops"):
        run.load_arch(run.ROOT, run.config_entry(bench, wl["config"]), conf,
                      train)


def test_kda_ops_and_bytes_by_hand():
    from retrieval_bench.archs import kimi_linear

    m = {"linear_attn_config": {"num_heads": 2, "head_dim": 4,
                                "kda_layers": [1, 3], "full_attn_layers": [2]}}
    # 3 multiply-adds a state entry (4 x 4 a head, 2 heads) a token
    assert kimi_linear.kda_ops(m, 5) == 2 * 3 * 16 * 2 * 5
    # q, k, v, f, the gate and out bf16 (2 B) over 8 channels, beta f32
    # over 2 heads, a token
    assert kimi_linear.kda_bytes(m, 5) == 5 * (6 * 8 * 2 + 2 * 4)
    assert kimi_linear.kda_layers(m) == 2


def test_the_held_share_of_experts_by_hand():
    from retrieval_bench.archs import deepseek_v2, kimi_linear

    m = {"hidden_size": 8, "moe_intermediate_size": 4,
         "num_experts_per_token": 4, "num_experts": 2,
         "expert_share": {"router_experts": 8, "first_held": 2},
         "num_hidden_layers": 3, "first_k_dense_replace": 1,
         "moe_layer_freq": 1}
    # 4 of 8 experts a token, 2 held: 1 held slot a token on average,
    # three products of 8 x 4 a slot
    assert kimi_linear.expert_ops(m, 5) == 2 * 3 * 8 * 4 * 1 * 5
    # the 2 held experts' three 8 x 4 bf16 matrices, and a held slot's
    # bf16 row of x in and its row out
    assert kimi_linear.expert_bytes(m, 5) == 2 * 3 * 8 * 4 * 2 + \
        5 * 1 * 2 * 8 * 2
    assert kimi_linear.moe_layers(m) == 2
    # holding every expert, the count is DeepSeek-V2's
    whole = {**m, "num_experts": 8}
    del whole["expert_share"]
    ds = {"hidden_size": 8, "moe_intermediate_size": 4,
          "num_experts_per_tok": 4, "n_routed_experts": 8}
    assert kimi_linear.expert_ops(whole, 5) == deepseek_v2.expert_ops(ds, 5)
    assert kimi_linear.expert_bytes(whole, 5) == \
        deepseek_v2.expert_bytes(ds, 5)
