"""The port's dense encoder (``LlamaBiDense``: final hidden states, per-token
L2 normalize, masked mean) against the JAX package's, with the JAX
``init_params`` weights carried across by ``params_from_jax``, at 2 layers
and hidden 64. Tolerance rtol 1e-4, atol 1e-6: the frameworks sum the
products in different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.encoder import (
    DecoderOnlyBiDense, LlamaBiDense, LlamaBiSparse,
)
from scaling_retriever_tpu_torch.models.weights import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _port_config(ref_cfg) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
          if f.name in fields and f.name not in ("dtype", "param_dtype")}
    return ModelConfig(**kw)


def _batch(vocab):
    rng = np.random.default_rng(3)
    ids = rng.integers(0, vocab, (4, 10)).astype(np.int32)
    mask = np.ones((4, 10), np.int32)
    mask[1, :4] = 0
    mask[2, :9] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_dense_encode_matches_reference(tiny_config, tied):
    cfg = dataclasses.replace(tiny_config, tie_word_embeddings=tied)
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(4))
    ids, mask = _batch(cfg.vocab_size)
    ref_model = ref_encoder.LlamaBiDense(params, cfg)
    want = np.asarray(ref_model.encode(jnp.asarray(ids), jnp.asarray(mask)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    if not tied:
        tree.pop("lm_head")       # a dense model carries no LM head
    pcfg = _port_config(cfg)
    model = LlamaBiDense(params_from_jax(tree, pcfg, "cpu"), pcfg)
    assert isinstance(model, DecoderOnlyBiDense)
    assert model.hidden_size == 64
    got = model.encode(ids, mask)
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(model.doc_encode(ids, mask).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(model.query_encode(ids, mask).numpy(),
                                  got.numpy())
    # a mean of unit vectors: norm <= 1
    assert (got.norm(dim=1) <= 1.0 + 1e-5).all()
    if not tied:
        assert model.params.lm_head is None
        with pytest.raises(ValueError, match="LM head"):
            LlamaBiSparse(model.params, pcfg).encode(ids, mask)
