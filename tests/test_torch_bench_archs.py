"""The benchmark's architecture seam in tier-1's reach: the cases of
``retrieval_bench/tests/test_rb_archs.py`` and
``retrieval_bench/tests/test_rb_kimi_linear.py`` (collected here as they
are), and each configuration's arch module, DeepSeek-V2's and
Kimi-Linear's included, defining what the kinds of its cells call, and
nothing a kind it has no cell of would need in its place."""

from __future__ import annotations

import importlib

import pytest

from retrieval_bench import run
from retrieval_bench.tests.test_rb_archs import (  # noqa: F401
    one_thread, test_a_bad_arch_ends_the_run_naming_the_path,
    test_a_non_llama_architecture_is_added_as_new_files,
    test_every_configuration_names_an_arch_that_its_cells_can_use,
    test_the_decoder_encoder_holds_the_drawn_weights_bit_for_bit,
    test_the_decoder_flops_are_unchanged,
    test_the_run_is_judged_against_the_configuration_s_reference)
from retrieval_bench.tests.test_rb_kimi_linear import (  # noqa: F401
    test_a_port_without_kimi_linear_ends_the_run_at_its_arch,
    test_kda_ops_and_bytes_by_hand, test_the_held_share_of_experts_by_hand)

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _arch_and_kind(cell: str):
    wl, conf, traffic = run.cell_spec(BENCH, cell)
    kind = importlib.import_module(f"retrieval_bench.kinds.{traffic['kind']}")
    entry = run.config_entry(BENCH, wl["config"])
    return run.load_arch(run.ROOT, entry, conf, kind), kind, conf


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_s_arch_defines_what_its_kind_calls(cell):
    arch, kind, conf = _arch_and_kind(cell)
    for name in getattr(kind, "ARCH", ()):
        assert callable(getattr(arch, name)), (cell, name)
    assert conf["arch"] in ("bidir_decoder", "deepseek_v2", "kimi_linear")


def test_the_deepseek_cell_takes_its_own_arch_and_no_training():
    arch, kind, conf = _arch_and_kind("deepseek-v2-lite.text-long")
    assert conf["arch"] == "deepseek_v2" and kind.__name__.endswith(
        "text_serving")
    for name in ("expert_ops", "expert_bytes", "moe_layers"):
        assert callable(getattr(arch, name))
    train = importlib.import_module("retrieval_bench.kinds.train")
    assert not [f for f in train.ARCH
                if f not in kind.ARCH and hasattr(arch, f)]
    entry = run.config_entry(BENCH, "deepseek-v2-lite")
    with pytest.raises(SystemExit, match="defines no train_flops"):
        run.load_arch(run.ROOT, entry, conf, train)


def test_the_deepseek_configuration_states_its_source_config_as_published():
    # the source's config.json stands at the file's top level; the kinds
    # read the model from "model", which has to repeat it key for key
    conf = run.load_json(run.ROOT, run.config_entry(BENCH, "deepseek-v2-lite")
                         ["file"])
    m = conf["model"]
    assert {k: conf.get(k, KeyError) for k in m} == m
    assert (m["first_k_dense_replace"], m["n_routed_experts"],
            m["num_experts_per_tok"], m["kv_lora_rank"]) == (1, 64, 6, 512)
    assert m["q_lora_rank"] is None and m["rope_scaling"]["type"] == "yarn"
