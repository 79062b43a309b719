"""A run with the timed path broken underneath comes out not correct,
once for each fault its cell can have (a token or an answer altered where
it is produced, half of a batch left out, a step that leaves its state
unchanged), while the same run unbroken is correct, each against its
cell's own limits. The harness's look for a card is skipped: the run is
driven at a tiny size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from retrieval_bench import check, run
from retrieval_bench.tests.helpers import run_tiny


def _alter_answer(monkeypatch, method):
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    orig = getattr(SegsortEngine, method)

    def altered(*a):
        out = orig(*a)
        rows = out[1]
        rows[:, 0] = (rows[:, 0] + 1) % 5000
        return out

    monkeypatch.setattr(SegsortEngine, method,
                        staticmethod(altered) if method == "finalize_handoff"
                        else lambda self, p: altered(self, p))


def _alter_encode(monkeypatch, how):
    from scaling_retriever_tpu_torch.serving import text_frontend

    orig = text_frontend._top_t

    def broken(model, ids, mask, t):
        if how == "token":
            ids = ids.copy()
            ids[:, -1] = (ids[:, -1] + 1) % 512
            return orig(model, ids, mask, t)
        terms, vals = orig(model, ids, mask, t)
        # every second row left out: it gets its neighbour's rep
        kept = torch.arange(terms.shape[0], device=terms.device) // 2 * 2
        return terms[kept], vals[kept]

    monkeypatch.setattr(text_frontend, "_top_t", broken)


def _skip_update(monkeypatch):
    from scaling_retriever_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(Trainer, "_apply", lambda self, grads: None)


def _half_nce(monkeypatch):
    from scaling_retriever_tpu_torch.models import losses

    orig = losses.nce_loss

    def half(q, c, labels, temperature=1.0):
        n = q.shape[0] // 2
        return orig(q[:n], c, labels[:n], temperature)

    monkeypatch.setattr(losses, "nce_loss", half)


FAULTS = {
    ("qwen2-1.5b.text-short", "answer"):
        lambda mp: _alter_answer(mp, "finalize_handoff"),
    ("qwen2-1.5b.text-short", "token"): lambda mp: _alter_encode(mp, "token"),
    ("qwen2-1.5b.text-short", "half_batch"):
        lambda mp: _alter_encode(mp, "half"),
    ("mistral-7b.text-long", "answer"):
        lambda mp: _alter_answer(mp, "finalize_handoff"),
    ("mistral-7b.stream", "answer"): lambda mp: _alter_answer(mp, "finalize"),
    ("qwen2-1.5b.train-nce", "unchanged_state"): _skip_update,
    ("qwen2-1.5b.train-nce", "half_batch"): _half_nce,
}


def _limits(cell):
    lim = check.limits(run.ROOT, cell)
    if any(v is None for v in lim.values()):
        pytest.fail(f"{cell}: limits not set")
    return lim


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_the_sound_tiny_run_is_correct(cell):
    res = run_tiny(cell, limits=_limits(cell))
    assert res["correct"], res["compared"]


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_planted_fault_comes_out_not_correct(cell, fault, monkeypatch):
    FAULTS[(cell, fault)](monkeypatch)
    res = run_tiny(cell, limits=_limits(cell))
    assert not res["correct"], res["compared"]


def test_the_lower_precision_control_comes_out_not_correct():
    for cell in ("qwen2-1.5b.text-short", "mistral-7b.stream",
                 "qwen2-1.5b.train-nce"):
        res = run_tiny(cell, control=True, limits=_limits(cell))
        control = {k.split(".", 1)[-1]: v for k, v in
                   res["out"]["control"].items() if not k.startswith("half")}
        ok, _ = check.judge(control, _limits(cell))
        assert not ok, (cell, control)
        assert np.isfinite(list(control.values())).all()
