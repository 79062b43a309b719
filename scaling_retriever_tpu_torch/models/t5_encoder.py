"""T5Sparse retriever (port of models/t5_encoder.py).

Encode runs the whole encoder-decoder with ``decoder_input_ids =
input_ids`` (and the decoder mask = the attention mask; T5 pads on the
right), then pools the decoder logits per token:
``max_s(log1p(relu(x)) * mask)``, with the logits scaled by
``d_model**-0.25`` only when ``d_model >= 2048`` (the reference's rule;
t5-base and t5-large are not scaled). The LoRA factors cover both stacks
(``models/t5.py``); adapters load and save in the peft T5 layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from scaling_retriever_tpu_torch.models import t5
from scaling_retriever_tpu_torch.models.encoder import (LLM2Retriever,
                                                        _resolve_model_dir)
from scaling_retriever_tpu_torch.models.lora import LoraConfig
from scaling_retriever_tpu_torch.ops.pooling import sparse_pool_per_token


class T5Sparse(LLM2Retriever):
    MODEL_TYPE = "t5"
    POOLING = "sparse"
    BASE_MODEL_CLASS = "T5ForConditionalGeneration"
    TARGET_MODULES = t5.T5_TARGET_MODULES

    @property
    def hidden_size(self) -> int:
        return self.config.d_model

    def encode_pure(self, params: t5.T5ForConditionalGeneration,
                    lora: Optional[dict], input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    dropout_seed: Optional[int] = None,
                    part=None) -> torch.Tensor:
        """[B, S] ids and mask → [B, V] f32 reps. ``dropout_seed`` and
        ``part`` are taken and unused: the reference's T5 forward has no
        LoRA dropout, so a rank's rows need no mask."""
        scale = (self.lora_config.scaling
                 if lora is not None and self.lora_config else 0.0)
        logits = params.forward_logits(input_ids, attention_mask, input_ids,
                                       attention_mask, lora, scale)
        return sparse_pool_per_token(logits, attention_mask,
                                     self.config.d_model,
                                     self.config.d_model >= 2048)

    @classmethod
    def build(cls, model_name_or_path: str, args, config=None,
              generator: Optional[torch.Generator] = None, device="cuda",
              **overrides) -> "T5Sparse":
        """Training setup: base weights plus a new LoRA over the reference's
        T5 targets when ``args.lora``."""
        params, cfg = t5.load_pretrained(
            _resolve_model_dir(model_name_or_path), device=device,
            **overrides)
        if not getattr(args, "lora", False):
            return cls(params, cfg)
        lora_config = LoraConfig(
            r=args.lora_r, lora_alpha=args.lora_alpha,
            lora_dropout=getattr(args, "lora_dropout", 0.0),
            target_modules=t5.T5_TARGET_MODULES,
            base_model_name_or_path=model_name_or_path,
            base_model_class=cls.BASE_MODEL_CLASS)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        lora = t5.init_lora_params(cfg, args.lora_r, generator,
                                   device=device)
        return cls(params, cfg, lora, lora_config)

    def merge_and_unload(self) -> "T5Sparse":
        """Fold LoRA into the base weights (in place, so this object drops
        its adapter too) and return the merged model."""
        if self.lora is None:
            return self
        merged = t5.merge_lora(self.params, self.lora,
                               self.lora_config.scaling)
        self.lora = self.lora_config = None
        return type(self)(merged, self.config)

    @classmethod
    def load(cls, model_name_or_path: str,
             lora_name_or_path: Optional[str] = None, merge_peft: bool = True,
             is_trainable: bool = False, T: float = 0.01, device="cuda",
             **overrides) -> "T5Sparse":
        """Base weights on ``device`` plus an optional peft T5 adapter:
        merged by default, kept apart with ``merge_peft=False`` or
        ``is_trainable`` (then its factors require grad)."""
        params, cfg = t5.load_pretrained(
            _resolve_model_dir(model_name_or_path), device=device,
            **overrides)
        lora = lora_config = None
        if lora_name_or_path:
            lora, lora_config = t5.load_adapter(
                _resolve_model_dir(lora_name_or_path), cfg, device=device)
            if is_trainable:
                for side in lora.values():
                    for fac in side["layers"].values():
                        for t in fac.values():
                            t.requires_grad_(True)
            elif merge_peft:
                params = t5.merge_lora(params, lora, lora_config.scaling)
                lora = lora_config = None
        return cls(params, cfg, lora, lora_config)

    def save_pretrained(self, save_dir: str) -> None:
        if self.lora is not None:
            t5.save_adapter(self.lora, self.lora_config, save_dir)
        else:
            t5.save_pretrained(self.params, self.config, save_dir)

    @torch.no_grad()
    def save_trained(self, trainable, out_dir: str,
                     use_lora: bool = True) -> None:
        """The trainer's artifact: a peft T5 adapter (full-parameter T5
        checkpoints are outside the reference's surface)."""
        if not use_lora or self.lora_config is None:
            raise ValueError("T5Sparse trains LoRA adapters only")
        t5.save_adapter(trainable, self.lora_config, out_dir)


class T5SparseForMarginMSE(T5Sparse):
    LOSS_TYPE = "margin_mse"
