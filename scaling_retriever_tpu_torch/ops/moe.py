"""The routed experts of a mixture-of-experts layer (DeepSeek-V2's MoE)
over device-side offsets, so that a captured CUDA graph serves every
routing (no counterpart in the JAX package, which has no mixture of
experts).

A layer of N tokens routes each to k of E experts: N * k slots, slot
``t * k + j`` holding token t's j-th expert and routing weight. The
kernels (``csrc/moe.cu``) run as four launches with no host read and no
data-dependent shape:

* ``route``: each expert's slot count, their exclusive offsets, the
  expert-sorted slot list (``order``, slots in slot order within an
  expert) and its inverse (``inv``), the count added to a persistent
  load counter, and the two products' work counters zeroed (kernel
  ``moe_route``);
* ``expert_up``: for each expert, its slots' token rows of x (gathered
  inside the kernel) times the expert's fused [W_g; W_u], and
  ``silu(g) * u`` → the [N * k, I] intermediate in sorted order
  (``moe_expert_up``);
* ``expert_down``: the intermediate times the expert's W_d, scaled by the
  slot's routing weight → [N * k, H] in sorted order
  (``moe_expert_down``);
* ``combine``: each token's k rows summed in slot order in float32 (no
  atomics: the same bits every run), rounded, plus the shared experts'
  row (``moe_combine``).

A layer may hold a share of the router's experts, as one card does where
a layer's experts are split over several (expert parallelism, run here
without its exchange): the E held experts are the router's ids ``first``
.. ``first + E - 1``. A slot routed to an expert held elsewhere is absent:
``route`` counts and orders only present slots (``offsets[E]`` of them;
``order`` past that is unused) and gives an absent slot the inverse -1,
the products do no work for it, and ``combine`` leaves it out of its
token's sum. A layer that holds every expert is the share from 0, where
no slot is absent.

All E experts' weights lie stacked, one tensor a projection: ``w_gu``
[E, 2 * I, H] (each expert's gate rows, then its up rows) and ``w_d``
[E, H, I]. Each function has a plain PyTorch version here (a loop over
the experts with index selection), which the wrapper takes for CPU
tensors only; on the card it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from scaling_retriever_tpu_torch.ops import cuda_lib

MAX_EXPERTS = 64      # the products' block finds its expert in one warp
ROW_TILE = 128        # the products' rows a work item (csrc/moe.cu BM)


class Routing(NamedTuple):
    offsets: torch.Tensor   # [E + 1] int32: expert e's slots at [o[e], o[e+1])
    order: torch.Tensor     # [N * k] int32: the slot at each sorted position
    inv: torch.Tensor       # [N * k] int32: each slot's sorted position (-1:
    # absent)
    # [2] int32, zero: the up and the down product's work-item counters
    # (each launch leaves its own at zero again)
    work: torch.Tensor


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} for device {t.device}")
    return True


# ---- plain versions ----------------------------------------------------------


def route_plain(ids: torch.Tensor, n_experts: int,
                load: Optional[torch.Tensor] = None, first: int = 0,
                absent: Optional[torch.Tensor] = None) -> Routing:
    local = ids.reshape(-1) - first
    present = (local >= 0) & (local < n_experts)
    flat = torch.where(present, local, n_experts)   # absent: sorted last
    if absent is not None:
        absent += (~present).sum()
    counts = torch.bincount(flat, minlength=n_experts + 1)[:n_experts]
    offsets = torch.zeros(n_experts + 1, dtype=torch.int64, device=ids.device)
    offsets[1:] = torch.cumsum(counts, 0)
    order = torch.sort(flat, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=ids.device)
    inv[~present] = -1
    if load is not None:
        load += counts
    return Routing(offsets.int(), order.int(), inv.int(),
                   torch.zeros(2, dtype=torch.int32, device=ids.device))


def _expert_rows(routing: Routing, e: int) -> slice:
    o = routing.offsets
    return slice(int(o[e]), int(o[e + 1]))


def expert_up_plain(x: torch.Tensor, routing: Routing, w_gu: torch.Tensor,
                    k: int) -> torch.Tensor:
    n_i = w_gu.shape[1] // 2
    out = torch.empty(len(routing.order), n_i, dtype=x.dtype, device=x.device)
    for e in range(w_gu.shape[0]):
        rows = _expert_rows(routing, e)
        xe = x[routing.order[rows].long() // k].float()
        gu = xe @ w_gu[e].float().T
        out[rows] = (F.silu(gu[:, :n_i]) * gu[:, n_i:]).to(x.dtype)
    return out


def expert_down_plain(hmid: torch.Tensor, routing: Routing, w_d: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    out = torch.empty(len(routing.order), w_d.shape[1], dtype=hmid.dtype,
                      device=hmid.device)
    w_flat = weights.reshape(-1)
    for e in range(w_d.shape[0]):
        rows = _expert_rows(routing, e)
        y = hmid[rows].float() @ w_d[e].float().T
        out[rows] = (y * w_flat[routing.order[rows].long()][:, None]).to(
            hmid.dtype)
    return out


def combine_plain(y: torch.Tensor, routing: Routing, shared: torch.Tensor,
                  k: int) -> torch.Tensor:
    n = shared.shape[0]
    inv = routing.inv.long()
    rows = y[inv.clamp_min(0)].view(n, k, -1).float()
    rows = torch.where((inv >= 0).view(n, k, 1), rows, 0.0)
    acc = rows[:, 0]
    for j in range(1, k):
        acc = acc + rows[:, j]
    return (acc.to(y.dtype).float() + shared.float()).to(shared.dtype)


def routed_experts_plain(x, ids, weights, w_gu, w_d, shared, load=None,
                         first=0, absent=None) -> torch.Tensor:
    k = ids.shape[1]
    routing = route_plain(ids, w_gu.shape[0], load, first, absent)
    hmid = expert_up_plain(x, routing, w_gu, k)
    return combine_plain(expert_down_plain(hmid, routing, w_d, weights),
                         routing, shared, k)


# ---- the kernels -------------------------------------------------------------


def route(ids: torch.Tensor, n_experts: int,
          load: Optional[torch.Tensor] = None, first: int = 0,
          absent: Optional[torch.Tensor] = None) -> Routing:
    """ids [N, k] int64 expert ids → ``Routing`` over the ``n_experts``
    held from ``first``; ``load`` ([E] int64) gains each held expert's
    slot count, ``absent`` ([1] int64) the absent slots."""
    if not _on_card(ids, "route"):
        return route_plain(ids, n_experts, load, first, absent)
    dev = ids.device
    cuda_lib.check_cuda("ids", ids, torch.int64, dev)
    if load is not None:
        cuda_lib.check_cuda("load", load, torch.int64, dev)
        if load.shape != (n_experts,):
            raise ValueError(f"load is {tuple(load.shape)}, expected "
                             f"({n_experts},)")
    if absent is None:
        absent = torch.zeros(1, dtype=torch.int64, device=dev)
    # one counter, added to by atomics: no vector access to align for
    if (absent.device != dev or absent.dtype != torch.int64
            or absent.shape != (1,)):
        raise ValueError(f"absent is {absent.dtype} {tuple(absent.shape)} "
                         f"on {absent.device}, expected int64 (1,) on {dev}")
    n_slots = ids.numel()
    offsets = torch.empty(n_experts + 1, dtype=torch.int32, device=dev)
    order = torch.empty(n_slots, dtype=torch.int32, device=dev)
    inv = torch.empty(n_slots, dtype=torch.int32, device=dev)
    work = torch.empty(2, dtype=torch.int32, device=dev)
    cuda_lib.launch("moe_route", "srt_moe_route", dev, ids.data_ptr(),
                    n_slots, n_experts, first, offsets.data_ptr(),
                    order.data_ptr(), inv.data_ptr(),
                    None if load is None else load.data_ptr(),
                    absent.data_ptr(), work.data_ptr())
    return Routing(offsets, order, inv, work)


def expert_up(x: torch.Tensor, routing: Routing, w_gu: torch.Tensor,
              k: int) -> torch.Tensor:
    """x [N, H], w_gu [E, 2I, H] → [N * k, I] ``silu(x W_g^T) * x W_u^T``
    of each slot's token and expert, in sorted order."""
    if not _on_card(x, "expert_up"):
        return expert_up_plain(x, routing, w_gu, k)
    dev = x.device
    n_e, two_i, h = w_gu.shape
    cuda_lib.check_cuda("x", x, torch.bfloat16, dev)
    cuda_lib.check_cuda("w_gu", w_gu, torch.bfloat16, dev)
    if x.shape[1] != h or h % 64 or two_i % 256:
        raise ValueError(f"expert_up takes x [N, H] with H % 64 == 0 and "
                         f"w_gu [E, 2I, H] with I % 128 == 0, got "
                         f"{tuple(x.shape)} and {tuple(w_gu.shape)}")
    n_slots = len(routing.order)
    out = torch.empty(n_slots, two_i // 2, dtype=torch.bfloat16, device=dev)
    if n_slots:
        cuda_lib.launch("moe_expert_up", "srt_moe_expert_up", dev,
                        x.data_ptr(), w_gu.data_ptr(),
                        routing.offsets.data_ptr(), routing.order.data_ptr(),
                        out.data_ptr(), routing.work.data_ptr(), n_slots,
                        n_e, k, h, two_i // 2)
    return out


def expert_down(hmid: torch.Tensor, routing: Routing, w_d: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """hmid [N * k, I] in sorted order, w_d [E, H, I], weights [N, k] f32
    → [N * k, H]: each row times its expert's W_d^T and its slot's
    weight."""
    if not _on_card(hmid, "expert_down"):
        return expert_down_plain(hmid, routing, w_d, weights)
    dev = hmid.device
    n_e, h, n_i = w_d.shape
    cuda_lib.check_cuda("hmid", hmid, torch.bfloat16, dev)
    cuda_lib.check_cuda("w_d", w_d, torch.bfloat16, dev)
    cuda_lib.check_cuda("weights", weights, torch.float32, dev)
    if hmid.shape[1] != n_i or h % 256 or n_i % 64:
        raise ValueError(f"expert_down takes w_d [E, H, I] with H % 256 == "
                         f"0 and I % 64 == 0 over hmid [N * k, I], got "
                         f"{tuple(w_d.shape)} and {tuple(hmid.shape)}")
    n_slots = len(routing.order)
    out = torch.empty(n_slots, h, dtype=torch.bfloat16, device=dev)
    if n_slots:
        cuda_lib.launch("moe_expert_down", "srt_moe_expert_down", dev,
                        hmid.data_ptr(), w_d.data_ptr(), weights.data_ptr(),
                        routing.offsets.data_ptr(), routing.order.data_ptr(),
                        out.data_ptr(), routing.work[1:].data_ptr(), n_slots,
                        n_e, h, n_i)
    return out


def combine(y: torch.Tensor, routing: Routing, shared: torch.Tensor,
            k: int) -> torch.Tensor:
    """y [N * k, H] in sorted order, shared [N, H] → [N, H]: each token's
    present rows of its k summed in slot order, plus its shared row."""
    if not _on_card(y, "combine"):
        return combine_plain(y, routing, shared, k)
    dev = y.device
    cuda_lib.check_cuda("y", y, torch.bfloat16, dev)
    cuda_lib.check_cuda("shared", shared, torch.bfloat16, dev)
    n, h = shared.shape
    if y.shape != (n * k, h) or h % 8:
        raise ValueError(f"combine takes y [N * k, H] and shared [N, H] with "
                         f"H % 8 == 0, got {tuple(y.shape)} and "
                         f"{tuple(shared.shape)}")
    out = torch.empty_like(shared)
    if n:
        cuda_lib.launch("moe_combine", "srt_moe_combine", dev, y.data_ptr(),
                        routing.inv.data_ptr(), shared.data_ptr(),
                        out.data_ptr(), n, k, h)
    return out


def routed_experts(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                   w_gu: torch.Tensor, w_d: torch.Tensor, shared: torch.Tensor,
                   load: Optional[torch.Tensor] = None, first: int = 0,
                   absent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H]; ids [N, k] int64 and weights [N, k] f32 (the router's
    choice); shared [N, H] (the shared experts' output) → [N, H]:
    ``sum_j weights[:, j] * E_{ids[:, j]}(x) + shared`` over the slots
    whose expert is held (the E of ``w_gu`` from ``first``).
    ``load`` [E] int64 gains each held expert's slot count, ``absent`` [1]
    int64 the slots routed elsewhere."""
    n_e = w_gu.shape[0]
    if n_e > MAX_EXPERTS:
        raise NotImplementedError(f"{n_e} routed experts: the kernels take "
                                  f"at most {MAX_EXPERTS}")
    k = ids.shape[1]
    routing = route(ids, n_e, load, first, absent)
    hmid = expert_up(x, routing, w_gu, k)
    return combine(expert_down(hmid, routing, w_d, weights), routing, shared,
                   k)
