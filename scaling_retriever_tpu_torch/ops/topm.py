"""Per-block top-m selection (port of ops/pallas_topm.py).

For every row and every ``block``-wide block of an f32 slab: m rounds of
(max -> lowest index holding it -> mask to -inf). The values come out
descending with block-local int32 indices, ties to the lower index. Once a
block has fewer than m finite values left, each later round returns -inf
at index 0 (the lowest -inf lane, taken or not): the reference does this
and the port keeps it, so the plain version is the m-round loop itself,
not a stable sort.
"""

from __future__ import annotations

import torch

from scaling_retriever_tpu_torch.ops import cuda_lib


def block_topm_plain(s: torch.Tensor, m: int, block: int):
    nq, n = s.shape
    nblk = n // block
    x = s.reshape(nq, nblk, block).clone()
    lane = torch.arange(block, device=s.device)
    vals = torch.empty(nq, nblk, m, dtype=torch.float32, device=s.device)
    idxs = torch.empty(nq, nblk, m, dtype=torch.int32, device=s.device)
    for j in range(m):
        mv = x.amax(dim=-1, keepdim=True)
        idx = torch.where(x == mv, lane, block).amin(dim=-1, keepdim=True)
        vals[:, :, j] = mv[:, :, 0]
        idxs[:, :, j] = idx[:, :, 0].to(torch.int32)
        x.scatter_(-1, idx, float("-inf"))
    return vals, idxs


def block_topm(s: torch.Tensor, m: int, block: int):
    """Top-``m`` of every ``block`` lanes of ``s`` [nq, n] f32 → (vals
    [nq, n/block, m] descending, idxs [nq, n/block, m] block-local int32);
    kernel B5 on CUDA (block a multiple of 1024, at most 12288; m <= 128)."""
    nq, n = s.shape
    nblk = n // block
    if nblk * block != n or not 1 <= m <= min(128, block):
        raise ValueError(f"block_topm: n={n}, block={block}, m={m}")
    if s.device.type == "cpu":
        return block_topm_plain(s, m, block)
    if s.device.type != "cuda":
        raise ValueError(f"no block_topm for device {s.device}")
    if block % 1024 or block > 12288 or nq > 65535:
        raise ValueError(f"block_topm kernel takes block % 1024 == 0, "
                         f"block <= 12288 and nq <= 65535 (block={block}, "
                         f"nq={nq})")
    dev = s.device
    cuda_lib.check_cuda("s", s, torch.float32, dev)
    vals = torch.empty(nq, nblk, m, dtype=torch.float32, device=dev)
    idxs = torch.empty(nq, nblk, m, dtype=torch.int32, device=dev)
    if nq and nblk:
        cuda_lib.launch("topm", "srt_topm", dev, s.data_ptr(),
                        vals.data_ptr(), idxs.data_ptr(), nq, nblk, block, m)
    return vals, idxs
