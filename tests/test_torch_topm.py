"""Per-block top-m of the torch port (scaling_retriever_tpu_torch/ops/topm.py)
against the JAX package's ``block_topm`` (Pallas, interpret mode on the
CPU): values and indices bit for bit, ties and exhausted blocks included,
over the kernel's whole (m, block) range and on adversarial blocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.ops.pallas_topm import block_topm as ref_topm
from scaling_retriever_tpu_torch.ops import topm

torch.set_num_threads(1)


def _slab(rng, nq, n, block):
    s = rng.standard_normal((nq, n)).astype(np.float32)
    s[0, 10:14] = s[0, 3]                      # ties within a block
    s[1 % nq, :] = np.round(s[1 % nq, :])      # many ties
    s[2 % nq, block:2 * block] = -np.inf       # an empty block
    exhausted = np.full(block, -np.inf, np.float32)
    exhausted[[5, 9, 17]] = [1.0, 3.0, 2.0]    # 3 finite values < m
    s[3 % nq, 2 * block:3 * block] = exhausted
    return s


def _check(s, m, block):
    want_v, want_i = ref_topm(jnp.asarray(s), m=m, block=block,
                              interpret=True)
    got_v, got_i = topm.block_topm(torch.from_numpy(s), m, block)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    return got_v.numpy(), got_i.numpy()


# m up to 128 and block from 128 to 4096: the engine's (32, 4096), its m
# at 8 blocks and k = 1000 (125), and both ends of the range
WIDE = [(4, 3 * block, m, block) for block in (128, 1024, 4096)
        for m in (1, 32, 125, 128)]


@pytest.mark.parametrize("nq,n,m,block",
                         [(5, 512, 6, 128), (9, 4096, 32, 1024)] + WIDE)
def test_block_topm_matches_reference(nq, n, m, block):
    rng = np.random.default_rng(n + m)
    _check(_slab(rng, nq, n, block), m, block)


def _adversarial(kind, block, rng):
    """One block of ``kind``: every lane equal; every lane -inf; -0.0 and
    +0.0 alternating (-0.0 at lane 0); normals with two +inf lanes; three
    finite values among -inf lanes."""
    x = np.zeros(block, np.float32)
    if kind == "all_equal":
        x[:] = 1.5
    elif kind == "all_neg_inf":
        x[:] = -np.inf
    elif kind == "signed_zeros":
        x[0::2] = -0.0
    elif kind == "pos_inf":
        x[:] = rng.standard_normal(block)
        x[[block // 2, 3]] = np.inf
    else:
        x[:] = -np.inf
        x[[5, 9, 17]] = [1.0, 3.0, 2.0]
    return x


@pytest.mark.parametrize("m,block", [(1, 128), (128, 128), (32, 4096),
                                     (125, 4096)])
@pytest.mark.parametrize("kind", ["all_equal", "all_neg_inf", "signed_zeros",
                                  "pos_inf", "exhausted"])
def test_block_topm_adversarial_blocks(kind, m, block):
    """The block in every slot of a [2, 2 * block] slab but one, which
    holds normals; the reference's answer, and what it must be."""
    rng = np.random.default_rng(block + m)
    x = _adversarial(kind, block, rng)
    s = np.tile(x, (2, 2))
    s[1, block:] = rng.standard_normal(block)
    v, i = _check(s, m, block)
    v, i = v[0, 0], i[0, 0]
    lanes = np.arange(m)
    if kind in ("all_equal", "signed_zeros"):
        assert (i == lanes).all() and (v == x[0]).all()
    elif kind == "all_neg_inf":
        assert (i == 0).all() and np.isneginf(v).all()
    elif kind == "pos_inf":
        assert i[:min(m, 2)].tolist() == [3, block // 2][:m]
        assert np.isposinf(v[:min(m, 2)]).all()
    else:
        want = [9, 17, 5] + [0] * max(0, m - 3)
        assert i.tolist() == want[:m]


def test_exhausted_block_repeats_index_zero():
    """Finite values at lanes 5, 9, 17 and m = 6: the reference returns
    idxs [9, 17, 5, 0, 0, 0] (by value), every round after the third
    finding only -inf lanes and taking the lowest, lane 0."""
    s = np.full((1, 128), -np.inf, np.float32)
    s[0, [5, 9, 17]] = [1.0, 3.0, 2.0]
    v, i = _check(s, 6, 128)
    assert i[0, 0].tolist() == [9, 17, 5, 0, 0, 0]
    assert np.isneginf(v[0, 0, 3:]).all()


def test_block_topm_rejects_bad_shapes():
    """The reference's own checks, on any device: n % block == 0 and
    1 <= m <= min(128, block)."""
    for n, m, block in ((100, 4, 64), (256, 129, 256), (256, 0, 256),
                        (128, 65, 64), (384, 4, 256)):
        with pytest.raises(ValueError, match="block_topm takes"):
            topm.block_topm(torch.zeros(2, n), m, block)
    v, i = topm.block_topm(torch.zeros(2, 128), 64, 64)   # in the contract
    assert v.shape == i.shape == (2, 2, 64)


@pytest.mark.parametrize("nq,nblk,block,ok", [
    (1, 1, 128, True), (65535, 2, 4096, True), (70000, 1, 16384, True),
    (3, 4, 12288, True), (1, 1, 384, True), (1, 1, 64, False),
    (1, 1, 16512, False), (1, 1, 4000, False), (2 ** 21, 2 ** 10, 128, False)])
def test_block_topm_kernel_limits(nq, nblk, block, ok):
    """The CUDA kernel's stated limits, checked by the wrapper before a
    launch: block a multiple of 128 in [128, 16384], nq * n/block < 2^31."""
    if ok:
        topm.check_kernel_shape(nq, nblk, block)
    else:
        with pytest.raises(ValueError, match="block_topm kernel takes"):
            topm.check_kernel_shape(nq, nblk, block)
