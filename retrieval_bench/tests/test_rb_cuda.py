"""The four cells at a tiny size on the card (marked ``cuda``; the card is
looked for inside the fixture): the kernels' path against the reference
under each cell's limits."""

from __future__ import annotations

import pytest

from retrieval_bench import check, run
from retrieval_bench.tests.helpers import SEED, tiny_conf, tiny_traffic

CELLS = ("qwen2-1.5b.text-short", "mistral-7b.text-long",
         "mistral-7b.stream", "qwen2-1.5b.train-nce")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run.set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_on_the_card(card, cell):
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    res = run.run_cell(bench, cell, SEED, 0.5, True, card,
                       conf=tiny_conf(cell), traffic=tiny_traffic(bench, cell),
                       limits=check.limits(run.ROOT, cell))
    assert res["correct"], res["compared"]
    assert res["out"]["record"]["trace"].busy_s() > 0
