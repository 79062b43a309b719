"""Driver helpers (port of utils/utils.py) and a top-k comparator.

PyTorch launches kernels asynchronously: a call returns once the work is
queued on the stream. The pipelines below dispatch tiles ahead of the
blocking host read of the oldest, so the read of one tile overlaps the
device work of the next.
"""

from __future__ import annotations

import numpy as np
import torch


def depth2_pipeline(items, dispatch, drain, depth: int = 3) -> None:
    """Dispatch up to ``depth`` items (asynchronous calls returning device
    tensors) before draining the oldest (a blocking host read)."""
    pending: list = []
    for item in items:
        pending.append(dispatch(item))
        if len(pending) >= depth:
            drain(pending.pop(0))
    for p in pending:
        drain(p)


def staged_pipeline(items, dispatch, advance, drain,
                    d1: int = 2, d2: int = 2) -> None:
    """Dispatch-ahead loop for two-pass engines: ``dispatch`` runs d1
    items ahead of ``advance`` (reads pass 1, dispatches pass 2), which runs
    d2 items ahead of ``drain`` (the final blocking read)."""
    q1: list = []
    q2: list = []
    for item in items:
        q1.append(dispatch(item))
        if len(q1) >= d1:
            q2.append(advance(q1.pop(0)))
            if len(q2) >= d2:
                drain(q2.pop(0))
    for p in q1:
        q2.append(advance(p))
    for p in q2:
        drain(p)


def force_materialized(*tensors) -> None:
    """Block until the work producing these tensors has finished on their
    device (a CUDA synchronize per device; CPU tensors are already done)."""
    devices = {t.device for t in tensors
               if t is not None and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def tie_equal_topk(ids_a, scores_a, ids_b, scores_b, rtol: float = 1e-5,
                   atol: float = 0.0) -> None:
    """Raise AssertionError unless two top-k lists agree up to ties: the
    same number of entries, scores allclose position by position, the same
    ids wherever the score is clear of the list's last (boundary) score,
    and equal scores for ids present in both lists. Ids tied at the k
    boundary may differ."""
    sa = np.asarray(scores_a, np.float64)
    sb = np.asarray(scores_b, np.float64)
    if sa.shape != sb.shape:
        raise AssertionError(f"lengths differ: {sa.shape} vs {sb.shape}")
    np.testing.assert_allclose(sa, sb, rtol=rtol, atol=atol)
    if not sa.size:
        return
    boundary = max(sa[-1], sb[-1])
    thr = boundary + atol + rtol * abs(boundary)
    ids_a, ids_b = list(ids_a), list(ids_b)
    missing = ({i for i, s in zip(ids_a, sa) if s > thr} - set(ids_b)) | \
        ({i for i, s in zip(ids_b, sb) if s > thr} - set(ids_a))
    if missing:
        raise AssertionError(f"ids above the boundary score missing from "
                             f"the other list: {sorted(missing, key=str)[:10]}")
    # one vectorized compare: a scalar assert per id costs seconds over
    # thousands of 1000-long lists
    by_b = dict(zip(ids_b, sb))
    pairs = [(s, by_b[i]) for i, s in zip(ids_a, sa) if i in by_b]
    if pairs:
        got, want = np.array(pairs).T
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
