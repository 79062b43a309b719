"""Runtime and pipeline helpers (port of utils/utils.py) and a top-k
comparator.

PyTorch launches kernels asynchronously: a call returns once the work is
queued on the stream. The pipelines below dispatch tiles ahead of the
blocking host read of the oldest, so the read of one tile overlaps the
device work of the next.

The reference reduces across its mesh with a ``psum`` inside a sharded
program. Here one process holds every shard's value, so ``sum_to_main`` and
``distributed_weighted_average`` take the per-shard tensors and reduce
them on the first shard's device, in shard order.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def is_first_worker() -> bool:
    """True unless ``torch.distributed`` is initialized with a rank > 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() > 0)


def build_dir(default: str) -> str:
    """Where the port builds its native libraries: ``$SRT_BUILD_DIR/<last
    part of default>`` when that variable is set; else ``default`` (under
    the checkout's ``build/``) where it can be written, as in a checkout;
    else the user's cache (``$XDG_CACHE_HOME`` or ``~/.cache``), as for an
    install into a directory that cannot be written."""
    leaf = os.path.basename(os.path.normpath(default))
    root = os.environ.get("SRT_BUILD_DIR")
    if root:
        return os.path.join(root, leaf)
    probe = default
    while not os.path.exists(probe):
        probe = os.path.dirname(probe)
    if os.access(probe, os.W_OK):
        return default
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "scaling_retriever_tpu_torch", leaf)


def to_list(x) -> list:
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return np.asarray(x).tolist()


def supports_bfloat16(device="cuda") -> bool:
    """A card of compute capability >= 8 (Ampere on), or the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return True
    return torch.cuda.get_device_capability(device)[0] >= 8


def batch_to_device(batch: dict, device) -> dict:
    """Array and tensor leaves of ``batch`` as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def get_data_source(args) -> str:
    """The data source guessed from the first path ``args`` sets among
    corpus_path, query_path and train_path; "msmarco" without one."""
    from scaling_retriever_tpu_torch.constants import guess_data_source

    for attr in ("corpus_path", "query_path", "train_path"):
        path = getattr(args, attr, None)
        if path:
            return guess_data_source(path)
    return "msmarco"


def sum_to_main(values) -> torch.Tensor:
    """The sum of per-shard tensors, on the first one's device."""
    out = values[0]
    for v in values[1:]:
        out = out + v.to(out.device)
    return out


def distributed_weighted_average(values, weights) -> torch.Tensor:
    """sum(value * weight) / max(sum(weight), 1e-9) over per-shard
    tensors, on the first one's device."""
    total = sum_to_main([v * w for v, w in zip(values, weights)])
    return total / torch.clamp(sum_to_main(list(weights)), min=1e-9)


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
