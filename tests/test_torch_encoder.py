"""The torch port's bidirectional Llama sparse encoder against the JAX
package's ``encode_pure``, with the JAX ``init_params`` weights carried
across by ``params_from_jax``. Tolerance rtol 1e-4, atol 1e-5: the two
frameworks sum the matmuls in different orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaling_retriever_tpu.models import encoder as ref_encoder
from scaling_retriever_tpu.models import llama as ref_llama
from scaling_retriever_tpu.models.lora import LoraConfig as RefLoraConfig
from scaling_retriever_tpu.models.lora import init_lora_params
from scaling_retriever_tpu_torch.models.config import LLAMA_3_2_1B, ModelConfig
from scaling_retriever_tpu_torch.models.encoder import LlamaBiSparse
from scaling_retriever_tpu_torch.models.lora import LoraConfig
from scaling_retriever_tpu_torch.models.weights import (
    lora_from_jax, params_from_jax,
)
from scaling_retriever_tpu_torch.ops.pooling import dense_pool, sparse_pool

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LLAMA3_ROPE = {"factor": 32.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 64, "rope_type": "llama3"}


def _port_config(ref_cfg) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
          if f.name in fields and f.name not in ("dtype", "param_dtype")}
    return ModelConfig(**kw)


def _batch(vocab):
    """Left-padded rows, a full row, and an all-pad row."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, :3] = 0
    mask[2, :11] = 0
    mask[3, :] = 0
    ids[mask == 0] = 0
    return ids, mask


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("variant", ["as_is", "llama3_rope_tied"])
def test_encode_matches_reference(tiny_config, variant):
    cfg = tiny_config
    if variant != "as_is":
        cfg = dataclasses.replace(cfg, rope_scaling=LLAMA3_ROPE,
                                  tie_word_embeddings=True)
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(1))
    ids, mask = _batch(cfg.vocab_size)
    want = np.asarray(ref_encoder.LlamaBiSparse(params, cfg).encode_pure(
        params, None, jnp.asarray(ids), jnp.asarray(mask)))
    pcfg = _port_config(cfg)
    model = LlamaBiSparse(params_from_jax(_numpy_tree(params), pcfg, "cpu"),
                          pcfg)
    got = model.encode(ids, mask).numpy()
    assert got.shape == (4, cfg.vocab_size)
    assert (got[3] == 0).all() and (got[:3] > 0).any(axis=1).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lora_branch_and_merge_match_reference(tiny_config):
    cfg = tiny_config
    params = ref_llama.init_params(cfg, jax.random.PRNGKey(2))
    lcfg = RefLoraConfig(r=4, lora_alpha=8)
    lora = init_lora_params(cfg, lcfg, jax.random.PRNGKey(3))
    lora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                               x.shape), lora)
    ids, mask = _batch(cfg.vocab_size)
    want = np.asarray(ref_encoder.LlamaBiSparse(params, cfg, lora, lcfg)
                      .encode_pure(params, lora, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    pcfg = _port_config(cfg)
    model = LlamaBiSparse(params_from_jax(_numpy_tree(params), pcfg, "cpu"),
                          pcfg, lora_from_jax(_numpy_tree(lora), "cpu"),
                          LoraConfig(r=4, lora_alpha=8))
    np.testing.assert_allclose(model.encode(ids, mask).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    merged = model.merge_and_unload()
    assert merged.lora is None
    np.testing.assert_allclose(merged.encode(ids, mask).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_pooling_matches_reference():
    from scaling_retriever_tpu.ops import pooling as ref_pooling

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    mask = np.array([[1] * 5, [0, 0, 1, 1, 1], [0] * 5], np.int32)
    np.testing.assert_allclose(
        sparse_pool(torch.from_numpy(x), torch.from_numpy(mask), 64).numpy(),
        np.asarray(ref_pooling.sparse_pool(jnp.asarray(x), jnp.asarray(mask),
                                           64)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        dense_pool(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(ref_pooling.dense_pool(jnp.asarray(x), jnp.asarray(mask))),
        rtol=1e-6, atol=1e-7)


def test_published_config_widths():
    """The Llama-3.2-1B preset the card runs: published widths, llama3
    rope, tied embeddings."""
    cfg = ModelConfig.from_hf_config(LLAMA_3_2_1B)
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.intermediate_size, cfg.vocab_size,
            cfg.head_dim_) == (16, 2048, 32, 8, 8192, 128256, 64)
    assert cfg.tie_word_embeddings and cfg.rope_theta == 500000.0
    assert cfg.rope_scaling["rope_type"] == "llama3"
