"""Sparse retriever encoder (port of the sparse classes of
models/encoder.py; losses, HF loading and the model registry are not
ported yet).

``LLM2Retriever`` owns (params, lora, config). ``params`` is the
``LlamaBiForMNTP`` module holding the weights, the counterpart of the JAX
package's parameter tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP
from scaling_retriever_tpu_torch.models.lora import LoraConfig, merge_lora
from scaling_retriever_tpu_torch.ops.pooling import sparse_pool


class LLM2Retriever:
    """Base retriever: text ids → SPLADE-style sparse reps over the vocab."""

    def __init__(self, params: LlamaBiForMNTP, config: ModelConfig,
                 lora: Optional[dict] = None,
                 lora_config: Optional[LoraConfig] = None):
        self.params = params
        self.config = config
        self.lora = lora
        self.lora_config = lora_config

    @property
    def device(self) -> torch.device:
        return self.params.device

    def encode_pure(self, params: LlamaBiForMNTP, lora: Optional[dict],
                    input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, S] ids and mask on the model's device → [B, V] f32 reps."""
        scale = (self.lora_config.scaling
                 if lora is not None and self.lora_config else 0.0)
        logits = params.forward_logits(input_ids, attention_mask, lora, scale)
        return sparse_pool(logits, attention_mask, self.config.hidden_size)

    @torch.inference_mode()
    def encode(self, input_ids, attention_mask) -> torch.Tensor:
        """ids and mask (numpy or tensors) → [B, V] f32 reps on the model's
        device."""
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        return self.encode_pure(self.params, self.lora, ids, mask)

    def query_encode(self, input_ids, attention_mask) -> torch.Tensor:
        return self.encode(input_ids, attention_mask)

    def merge_and_unload(self) -> "LLM2Retriever":
        """Fold LoRA into the base weights (in place) and drop the adapter."""
        if self.lora is None:
            return self
        merged = merge_lora(self.params, self.lora, self.lora_config)
        return type(self)(merged, self.config)


class DecoderOnlyBiSparse(LLM2Retriever):
    pass


class LlamaBiSparse(DecoderOnlyBiSparse):
    pass
