"""The attention block's one-call form (``ops/attention.py``
``rope_attention``) on the CPU: its plain version equals the two steps it
replaces bit for bit, in the layer too, and matches the JAX package's
``apply_rope`` and ``attention``. The kernel itself is held to the plain
version on the card (``tests/test_torch_attention_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu_torch.models import llama
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.weights import random_params
from scaling_retriever_tpu_torch.ops import attention as att

torch.set_num_threads(1)


def _inputs(b, s, n_q, n_kv, hd, dtype, seed=0):
    """Random q, k, v (k and v with a per-dimension offset, as a q/k/v
    bias gives), float32 rope tables and a left-padded mask's bias with
    a row holding one real token."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, s, n_q, hd, generator=g)
    k = torch.randn(b, s, n_kv, hd, generator=g) + torch.randn(hd,
                                                               generator=g)
    v = torch.randn(b, s, n_kv, hd, generator=g)
    cfg = ModelConfig(num_attention_heads=n_q, num_key_value_heads=n_kv,
                      hidden_size=n_q * hd)
    cos, sin = llama.rope_cos_sin(cfg, s, "cpu")
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[0, :s - 1] = 0
    if b > 1:
        mask[1, :s // 3] = 0
    return (q.to(dtype), k.to(dtype), v.to(dtype), cos, sin,
            llama.padding_bias(mask))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,n_q,n_kv,hd", [
    (3, 16, 6, 2, 32),      # GQA 3:1, one key block
    (2, 13, 8, 2, 16),      # GQA 4:1, odd S
    (2, 9, 4, 4, 32),       # no GQA, odd S
    (2, 70, 4, 1, 16),      # one KV head, S past one key block
    (2, 20, 6, 2, 48),      # another head dim the kernel takes
    (1, 17, 10, 2, 80),     # GQA 5:1, odd S, head dim 80
    (2, 12, 2, 2, 96),      # no GQA, head dim 96
])
def test_plain_version_is_the_two_steps_bit_for_bit(b, s, n_q, n_kv, hd,
                                                    dtype):
    q, k, v, cos, sin, bias = _inputs(b, s, n_q, n_kv, hd, dtype)
    want = llama.attention(llama.apply_rope(q, cos, sin),
                           llama.apply_rope(k, cos, sin), v, bias, None)
    got = att.rope_attention(q, k, v, cos, sin, bias)
    assert got.dtype == dtype and got.shape == (b, s, n_q * hd)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_q,n_kv", [(4, 2), (4, 4), (6, 1)])
def test_plain_version_matches_the_jax_package(n_q, n_kv):
    b, s, hd = 2, 11, 16
    q, k, v, cos, sin, bias = _inputs(b, s, n_q, n_kv, hd, torch.float32, 3)
    got = att.rope_attention(q, k, v, cos, sin, bias)
    j = [jnp.asarray(t.numpy()) for t in (q, k, v, cos, sin, bias)]
    want = ref_llama.attention(ref_llama.apply_rope(j[0], j[3], j[4]),
                               ref_llama.apply_rope(j[1], j[3], j[4]), j[2],
                               j[5], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("head_dim", [16, 32])
def test_layer_without_grad_equals_the_recorded_forward(head_dim):
    """A bf16 forward with grad off takes ``rope_attention``; one autograd
    records takes the two steps: on the CPU the same bits."""
    cfg = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=head_dim,
                      dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    model = random_params(cfg, 1, "cpu").requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(1, 64, (3, 10), generator=g)
    mask = torch.ones_like(ids)
    mask[0, :7] = 0
    with torch.no_grad():
        plain = model.forward_hidden(ids, mask)
    recorded = model.forward_hidden(ids, mask)
    assert recorded.requires_grad
    assert torch.equal(plain, recorded.detach())


@pytest.mark.parametrize("bad", ["kv_heads", "cos", "bias"])
def test_wrapper_raises_on_shapes_it_does_not_take(bad):
    q, k, v, cos, sin, bias = _inputs(2, 8, 6, 2, 16, torch.bfloat16)
    if bad == "kv_heads":
        k, v = k[:, :, :1].repeat(1, 1, 4, 1), v[:, :, :1].repeat(1, 1, 4, 1)
    elif bad == "cos":
        cos = cos[:, :8]
    else:
        bias = bias[:, :, :, :4]
    with pytest.raises(ValueError):
        att.rope_attention(q, k, v, cos, sin, bias)
