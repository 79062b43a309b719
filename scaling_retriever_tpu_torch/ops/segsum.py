"""Fused segmented sum + run-end mask (port of ops/pallas_segsum.py).

After the per-query doc-id sort, each doc's contributions sit in one run.
``segsum_mask`` writes every run's sum at the run's last slot and -inf
everywhere else, sentinel runs included. The kernel (``csrc/segsum.cu``)
reads the two sorted slabs once and writes the result once; its plain
version is the reference's Hillis-Steele doubling plus the run-end mask.
"""

from __future__ import annotations

import torch

from scaling_retriever_tpu_torch.ops import cuda_lib

LANES = 128


def eligible(P: int, max_run: int) -> bool:
    """Shapes that take the kernel, as in the reference: whole 8 x 128
    tiles and real runs of at most 128 postings. Other shapes take the
    plain doubling passes (segsort_scoring._rank_tail)."""
    return P % (8 * LANES) == 0 and P >= 8 * LANES and 1 <= max_run <= LANES


def _segsum_passes(out: torch.Tensor, srow: torch.Tensor, lo: int,
                   hi: int) -> torch.Tensor:
    """Hillis-Steele doubling passes with shifts lo, 2*lo, ... < hi; exact
    for runs up to ``hi`` when started at lo = 1."""
    nq = srow.shape[0]
    shift = lo
    while shift < hi:
        prev_v = torch.cat([out.new_zeros(nq, shift), out[:, :-shift]], dim=1)
        prev_k = torch.cat([srow.new_full((nq, shift), -1), srow[:, :-shift]],
                           dim=1)
        out = torch.where(prev_k == srow, out + prev_v, out)
        shift *= 2
    return out


def _run_end_mask(out: torch.Tensor, srow: torch.Tensor,
                  sentinel: int) -> torch.Tensor:
    is_end = torch.cat([srow[:, :-1] != srow[:, 1:],
                        torch.ones_like(srow[:, :1], dtype=torch.bool)], dim=1)
    return torch.where(is_end & (srow != sentinel), out, float("-inf"))


def segsum_mask_plain(srow: torch.Tensor, scontrib: torch.Tensor,
                      sentinel: int, max_run: int) -> torch.Tensor:
    passes = max(1, (max_run - 1).bit_length())
    out = _segsum_passes(scontrib, srow, 1, 1 << passes)
    return _run_end_mask(out, srow, sentinel)


def segsum_mask(srow: torch.Tensor, scontrib: torch.Tensor, sentinel: int,
                max_run: int) -> torch.Tensor:
    """srow [nq, P] int32 sorted ascending per row, scontrib [nq, P] f32 →
    [nq, P] f32: each run's total at its last slot, -inf elsewhere and on
    sentinel runs. Real runs must be <= max_run (kernel B4 on CUDA)."""
    nq, P = srow.shape
    if not eligible(P, max_run):
        raise ValueError(f"segsum_mask takes P % 1024 == 0 and max_run <= "
                         f"128, got P={P}, max_run={max_run}")
    if srow.device.type == "cpu":
        return segsum_mask_plain(srow, scontrib, sentinel, max_run)
    if srow.device.type != "cuda":
        raise ValueError(f"no segsum for device {srow.device}")
    dev = srow.device
    cuda_lib.check_cuda("srow", srow, torch.int32, dev)
    cuda_lib.check_cuda("scontrib", scontrib, torch.float32, dev)
    if scontrib.shape != srow.shape:
        raise ValueError("srow and scontrib differ in shape")
    out = torch.empty_like(scontrib)
    if nq:
        cuda_lib.launch("segsum", "srt_segsum", dev, srow.data_ptr(),
                        scontrib.data_ptr(), out.data_ptr(), nq, P,
                        int(sentinel))
    return out
