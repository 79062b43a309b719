"""Per-block top-m of the torch port (scaling_retriever_tpu_torch/ops/topm.py)
against the JAX package's ``block_topm`` (Pallas, interpret mode on the
CPU): values and indices bit for bit, ties and exhausted blocks included."""

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


@pytest.mark.parametrize("nq,n,m,block", [(5, 512, 6, 128), (9, 4096, 32, 1024)])
def test_block_topm_matches_reference(nq, n, m, block):
    rng = np.random.default_rng(n + m)
    _check(_slab(rng, nq, n, block), m, block)


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
    with pytest.raises(ValueError):
        topm.block_topm(torch.zeros(2, 100), 4, 64)
    with pytest.raises(ValueError):
        topm.block_topm(torch.zeros(2, 256), 129, 256)
