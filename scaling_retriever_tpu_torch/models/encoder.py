"""Retriever encoders (port of models/encoder.py): the sparse and dense
classes of the Llama, Qwen2 and Mistral families, their training losses
(``loss_forward``), checkpoint and adapter loading and saving, and the
model registry (the T5 family lives in ``models/t5_encoder.py``).

``LLM2Retriever`` owns (params, lora, config). ``params`` is the
``LlamaBiForMNTP`` module holding the weights, the counterpart of the JAX
package's parameter tree. ``POOLING`` picks the head, as in the reference:
"sparse" pools the LM-head logits (``sparse_pool``), "dense" mean-pools the
L2-normalized final hidden states (``dense_pool``) and never touches the
LM head. Training calls ``loss_forward`` with autograd on; ``encode`` runs
under ``torch.inference_mode``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from scaling_retriever_tpu_torch.models import losses
from scaling_retriever_tpu_torch.models.config import ModelConfig
from scaling_retriever_tpu_torch.models.hf_loader import (load_pretrained,
                                                         save_pretrained)
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP, fold_in
from scaling_retriever_tpu_torch.models.lora import (LoraConfig,
                                                    init_lora_params,
                                                    load_adapter, merge_lora,
                                                    save_adapter)
from scaling_retriever_tpu_torch.models.tile_graphs import TileGraphs
from scaling_retriever_tpu_torch.ops.pooling import dense_pool, sparse_pool
from scaling_retriever_tpu_torch.parallel.collectives import (Part,
                                                             gather_rows)
from scaling_retriever_tpu_torch.parallel.mesh import rank_part
from scaling_retriever_tpu_torch.utils.profiling import profile_span


def _resolve_model_dir(name_or_path: str) -> str:
    """A local dir, or a hub id resolved offline through
    ``SRT_MODEL_DIR_MAP`` (a json dict) or ``SRT_MODEL_CACHE``; nothing is
    fetched."""
    if os.path.isdir(name_or_path):
        return name_or_path
    map_json = os.environ.get("SRT_MODEL_DIR_MAP")
    if map_json:
        mapping = json.loads(map_json)
        if name_or_path in mapping:
            return mapping[name_or_path]
    cache = os.environ.get("SRT_MODEL_CACHE")
    if cache:
        cand = os.path.join(cache, name_or_path.replace("/", "--"))
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        f"model {name_or_path!r} is not a local directory; set "
        f"SRT_MODEL_DIR_MAP (json dict) or SRT_MODEL_CACHE to resolve hub "
        f"ids offline")


class LLM2Retriever:
    """Base retriever: text ids → sparse reps over the vocab ("sparse") or
    dense embeddings of the hidden size ("dense"). ``tile_graphs`` holds
    the CUDA graphs of the text frontend's tiles over this encoder
    (``models/tile_graphs.py``), freed with it."""

    MODEL_TYPE = "llama"
    POOLING = "sparse"           # "sparse" | "dense"
    LOSS_TYPE = "nce"            # nce | margin_mse | kldiv | nce_kldiv
    BASE_MODEL_CLASS = "LlamaBiForMNTP"

    def __init__(self, params: LlamaBiForMNTP, config: ModelConfig,
                 lora: Optional[dict] = None,
                 lora_config: Optional[LoraConfig] = None, T: float = 1.0):
        self.params = params
        self.config = config
        self.lora = lora
        self.lora_config = lora_config
        self.T = T
        self.tile_graphs = TileGraphs()

    @property
    def device(self) -> torch.device:
        return self.params.device

    @property
    def vocab_size(self) -> int:
        return self.config.vocab_size

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size

    def encode_pure(self, params: LlamaBiForMNTP, lora: Optional[dict],
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    dropout_seed: Optional[int] = None,
                    part: Optional[Part] = None) -> torch.Tensor:
        """[B, S] ids and mask on the model's device → [B, V] (sparse) or
        [B, H] (dense) f32 reps. ``dropout_seed`` turns the LoRA dropout
        on (training); ``part`` places the call in a step over several
        ranks."""
        on = lora is not None and self.lora_config is not None
        scale = self.lora_config.scaling if on else 0.0
        drop = self.lora_config.lora_dropout if on else 0.0
        if self.POOLING == "sparse":
            logits = params.forward_logits(input_ids, attention_mask, lora,
                                           scale, drop, dropout_seed, part)
            with profile_span("encoder.pool"):
                return sparse_pool(logits, attention_mask,
                                   self.config.hidden_size)
        hidden = params.forward_hidden(input_ids, attention_mask, lora, scale,
                                       drop, dropout_seed, part)
        with profile_span("encoder.pool"):
            return dense_pool(hidden, attention_mask)

    def loss_forward(self, params: LlamaBiForMNTP, lora: Optional[dict],
                     batch: dict, dropout_seed: Optional[int] = None,
                     mesh=None) -> dict:
        """The task losses of one batch, as the collators of
        ``data/collators.py`` lay it out (numpy arrays or tensors). Each
        encode call draws its dropout from ``fold_in(dropout_seed, call)``.
        The sparse head adds the FLOPS regularizers ``query_reg`` and
        ``doc_reg``; the dense head divides by ``T``, the sparse by 1.

        On a distributed ``mesh`` (the whole global batch on every rank)
        each rank encodes its rows of every encoded input that ``data``
        divides and gathers the reps over the data group, so the losses
        are the global batch's, as in the reference's one program; the
        labels and teacher scores are read whole."""
        dev = params.device
        counter = [0]

        def enc(input_ids, attention_mask):
            seed = (None if dropout_seed is None
                    else fold_in(dropout_seed, counter[0]))
            counter[0] += 1
            ids = torch.as_tensor(input_ids, device=dev)
            mask = torch.as_tensor(attention_mask, device=dev)
            part = rank_part(ids.shape[0], mesh)
            if part is None:
                return self.encode_pure(params, lora, ids, mask, seed)
            reps = self.encode_pure(params, lora, ids[part.local],
                                    mask[part.local], seed, part)
            return gather_rows(reps, mesh.group("data"))

        def arr(name):
            return torch.as_tensor(batch[name], device=dev)

        T = self.T if self.POOLING == "dense" else 1.0
        lt = self.LOSS_TYPE
        if lt == "margin_mse":
            q = enc(**batch["tokenized_query"])
            p = enc(**batch["pos_tokenized_doc"])
            n = enc(**batch["neg_tokenized_doc"])
            rank = losses.margin_mse_loss(q, p, n, arr("teacher_pos_scores"),
                                          arr("teacher_neg_scores"), T)
            if self.POOLING == "sparse":
                return {"rank": rank, "query_reg": losses.flops(q),
                        "doc_reg": (losses.flops(p) + losses.flops(n)) / 2.0}
            return {"rank": rank}
        if lt not in ("nce", "kldiv", "nce_kldiv"):
            raise NotImplementedError(lt)
        q = enc(**batch["tokenized_queries"])
        c = enc(**batch["tokenized_contexts"])
        if lt == "nce":
            out = {"rank": losses.nce_loss(q, c, arr("target_labels"), T)}
        elif lt == "kldiv":
            out = {"rank": losses.kldiv_loss(q, c, arr("teacher_scores"), T)}
        else:
            rank, nce, kl = losses.nce_kldiv_loss(
                q, c, arr("target_labels"), arr("teacher_scores"),
                arr("teacher_idxes"), T)
            out = {"rank": rank, "nce": nce, "kldiv": kl}
        if self.POOLING == "sparse":
            out["query_reg"] = losses.flops(q)
            out["doc_reg"] = losses.flops(c)
        return out

    @torch.inference_mode()
    def encode(self, input_ids, attention_mask) -> torch.Tensor:
        """ids and mask (numpy or tensors) → f32 reps on the model's
        device."""
        with profile_span("encoder.upload"):
            ids = torch.as_tensor(input_ids, device=self.device)
            mask = torch.as_tensor(attention_mask, device=self.device)
        return self.encode_pure(self.params, self.lora, ids, mask)

    def doc_encode(self, input_ids, attention_mask) -> torch.Tensor:
        return self.encode(input_ids, attention_mask)

    def query_encode(self, input_ids, attention_mask) -> torch.Tensor:
        return self.encode(input_ids, attention_mask)

    def rerank_forward(self, tokenized_queries: dict,
                       tokenized_docs: dict) -> torch.Tensor:
        """Pointwise dot-product rerank scores."""
        q = self.encode(**tokenized_queries)
        d = self.encode(**tokenized_docs)
        return (q * d).sum(dim=-1)

    def merge_and_unload(self) -> "LLM2Retriever":
        """Fold LoRA into the base weights and drop the adapter. The merge
        is in place, so this object drops its adapter too: both it and the
        returned one encode as the merged model."""
        if self.lora is None:
            return self
        merged = merge_lora(self.params, self.lora, self.lora_config)
        self.lora = self.lora_config = None
        self.tile_graphs = TileGraphs()    # they ran the adapter's branch
        return type(self)(merged, self.config, None, None, T=self.T)

    def save_pretrained(self, save_dir: str) -> None:
        if self.lora is not None:
            save_adapter(self.lora, self.lora_config, save_dir)
        else:
            save_pretrained(self.params, self.config, save_dir)

    @torch.no_grad()
    def save_trained(self, trainable, out_dir: str,
                     use_lora: bool = True) -> None:
        """The trainer's artifact: a peft adapter from the LoRA factors, or
        an HF checkpoint of the whole module (``--no_lora``)."""
        if use_lora and self.lora_config is not None:
            save_adapter(trainable, self.lora_config, out_dir)
        else:
            save_pretrained(trainable, self.config, out_dir)

    # -- constructors -------------------------------------------------------

    @classmethod
    def _default_T(cls, args) -> float:
        return getattr(args, "T", 0.01) if cls.POOLING == "dense" else 1.0

    @classmethod
    def build(cls, model_name_or_path: str, args,
              config: Optional[dict] = None,
              generator: Optional[torch.Generator] = None, device="cuda",
              **config_overrides) -> "LLM2Retriever":
        """Training setup: base weights plus a newly initialized LoRA when
        ``args.lora`` (``generator`` seeds it; seed 0 on ``device`` by
        default). ``config_overrides`` reach the model config (``dtype``,
        ``param_dtype``, ``remat``)."""
        model_dir = _resolve_model_dir(model_name_or_path)
        overrides = dict(config_overrides)
        if config:
            overrides.update({k: v for k, v in config.items()
                              if k in ModelConfig.__dataclass_fields__})
        params, model_config = load_pretrained(model_dir, device=device,
                                               **overrides)
        lora = lora_config = None
        if getattr(args, "lora", False):
            lora_config = LoraConfig(
                r=args.lora_r, lora_alpha=args.lora_alpha,
                lora_dropout=getattr(args, "lora_dropout", 0.0),
                base_model_name_or_path=model_name_or_path,
                base_model_class=cls.BASE_MODEL_CLASS)
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            lora = init_lora_params(model_config, lora_config, generator,
                                    device=device)
        return cls(params, model_config, lora, lora_config,
                   T=cls._default_T(args))

    @classmethod
    def load(cls, model_name_or_path: str,
             lora_name_or_path: Optional[str] = None, merge_peft: bool = True,
             is_trainable: bool = False, T: float = 0.01, device="cuda",
             **config_overrides) -> "LLM2Retriever":
        """Base weights on ``device``, plus an optional adapter: merged by
        default, kept apart with ``merge_peft=False``, and kept apart with
        its factors requiring grad (to train on) with ``is_trainable``."""
        model_dir = _resolve_model_dir(model_name_or_path)
        params, model_config = load_pretrained(model_dir, device=device,
                                               **config_overrides)
        lora = lora_config = None
        if lora_name_or_path:
            lora, lora_config = load_adapter(
                _resolve_model_dir(lora_name_or_path), model_config,
                device=device)
            if is_trainable:
                for group in lora["layers"].values():
                    for fac in group.values():
                        for t in fac.values():
                            t.requires_grad_(True)
            elif merge_peft:
                params = merge_lora(params, lora, lora_config)
                lora = lora_config = None
        t = T if cls.POOLING == "dense" else 1.0
        return cls(params, model_config, lora, lora_config, T=t)

    @classmethod
    def load_from_lora(cls, lora_name_or_path: str, merge_peft: bool = True,
                       is_trainable: bool = False, T: float = 0.01,
                       device="cuda", **config_overrides) -> "LLM2Retriever":
        """The base model named in the adapter's config, plus the
        adapter."""
        adapter_dir = _resolve_model_dir(lora_name_or_path)
        lc = LoraConfig.from_adapter_dir(adapter_dir)
        return cls.load(lc.base_model_name_or_path,
                        lora_name_or_path=adapter_dir, merge_peft=merge_peft,
                        is_trainable=is_trainable, T=T, device=device,
                        **config_overrides)


class DecoderOnlyBiSparse(LLM2Retriever):
    POOLING = "sparse"


class DecoderOnlyBiDense(LLM2Retriever):
    POOLING = "dense"


class LlamaBiSparse(DecoderOnlyBiSparse):
    MODEL_TYPE = "llama"
    BASE_MODEL_CLASS = "LlamaBiForMNTP"


class Qwen2BiSparse(DecoderOnlyBiSparse):
    MODEL_TYPE = "qwen2"
    BASE_MODEL_CLASS = "Qwen2BiForMNTP"


class LlamaBiDense(DecoderOnlyBiDense):
    MODEL_TYPE = "llama"
    BASE_MODEL_CLASS = "LlamaBiModel"


class Qwen2BiDense(DecoderOnlyBiDense):
    MODEL_TYPE = "qwen2"
    BASE_MODEL_CLASS = "Qwen2BiModel"


class MistralBiSparse(DecoderOnlyBiSparse):
    MODEL_TYPE = "mistral"
    BASE_MODEL_CLASS = "MistralBiForMNTP"


class MistralBiDense(DecoderOnlyBiDense):
    MODEL_TYPE = "mistral"
    BASE_MODEL_CLASS = "MistralBiModel"


def _variant(base, loss_type, name):
    cls = type(name, (base,), {"LOSS_TYPE": loss_type})
    cls.__module__ = __name__
    return cls


LlamaBiSparseForNCE = LlamaBiSparse
Qwen2BiSparseForNCE = Qwen2BiSparse
LlamaBiDenseForNCE = LlamaBiDense
Qwen2BiDenseForNCE = Qwen2BiDense

LlamaBiSparseForMarginMSE = _variant(LlamaBiSparse, "margin_mse",
                                     "LlamaBiSparseForMarginMSE")
LlamaBiSparseForKLDiv = _variant(LlamaBiSparse, "kldiv",
                                 "LlamaBiSparseForKLDiv")
LlamaBiSparseForNCE_KLDiv = _variant(LlamaBiSparse, "nce_kldiv",
                                     "LlamaBiSparseForNCE_KLDiv")
Qwen2BiSparseForMarginMSE = _variant(Qwen2BiSparse, "margin_mse",
                                     "Qwen2BiSparseForMarginMSE")
Qwen2BiSparseForKLDiv = _variant(Qwen2BiSparse, "kldiv",
                                 "Qwen2BiSparseForKLDiv")
Qwen2BiSparseForNCE_KLDiv = _variant(Qwen2BiSparse, "nce_kldiv",
                                     "Qwen2BiSparseForNCE_KLDiv")

LlamaBiDenseForMarginMSE = _variant(LlamaBiDense, "margin_mse",
                                    "LlamaBiDenseForMarginMSE")
LlamaBiDenseForKLDiv = _variant(LlamaBiDense, "kldiv", "LlamaBiDenseForKLDiv")
LlamaBiDenseForNCE_KLDiv = _variant(LlamaBiDense, "nce_kldiv",
                                    "LlamaBiDenseForNCE_KLDiv")
Qwen2BiDenseForMarginMSE = _variant(Qwen2BiDense, "margin_mse",
                                    "Qwen2BiDenseForMarginMSE")
Qwen2BiDenseForKLDiv = _variant(Qwen2BiDense, "kldiv", "Qwen2BiDenseForKLDiv")
Qwen2BiDenseForNCE_KLDiv = _variant(Qwen2BiDense, "nce_kldiv",
                                    "Qwen2BiDenseForNCE_KLDiv")


class _Registry(dict):
    """(model_type, pooling, loss) → encoder class. T5 (sparse, nce or
    margin_mse) registers on first lookup, as in the reference:
    ``models/t5_encoder.py`` imports this module."""

    def __missing__(self, key):
        if key and key[0] == "t5":
            from scaling_retriever_tpu_torch.models.t5_encoder import (
                T5Sparse, T5SparseForMarginMSE)

            self[("t5", "sparse", "nce")] = T5Sparse
            self[("t5", "sparse", "margin_mse")] = T5SparseForMarginMSE
            if key in self:
                return self[key]
        raise KeyError(key)


MODEL_REGISTRY = _Registry({
    ("llama", "sparse", "nce"): LlamaBiSparse,
    ("llama", "sparse", "margin_mse"): LlamaBiSparseForMarginMSE,
    ("llama", "sparse", "kldiv"): LlamaBiSparseForKLDiv,
    ("llama", "sparse", "nce_kldiv"): LlamaBiSparseForNCE_KLDiv,
    ("llama", "dense", "nce"): LlamaBiDense,
    ("llama", "dense", "margin_mse"): LlamaBiDenseForMarginMSE,
    ("llama", "dense", "kldiv"): LlamaBiDenseForKLDiv,
    ("llama", "dense", "nce_kldiv"): LlamaBiDenseForNCE_KLDiv,
    ("qwen2", "sparse", "nce"): Qwen2BiSparse,
    ("qwen2", "sparse", "margin_mse"): Qwen2BiSparseForMarginMSE,
    ("qwen2", "sparse", "kldiv"): Qwen2BiSparseForKLDiv,
    ("qwen2", "sparse", "nce_kldiv"): Qwen2BiSparseForNCE_KLDiv,
    ("qwen2", "dense", "nce"): Qwen2BiDense,
    ("qwen2", "dense", "margin_mse"): Qwen2BiDenseForMarginMSE,
    ("qwen2", "dense", "kldiv"): Qwen2BiDenseForKLDiv,
    ("qwen2", "dense", "nce_kldiv"): Qwen2BiDenseForNCE_KLDiv,
})

for _loss in ("nce", "margin_mse", "kldiv", "nce_kldiv"):
    MODEL_REGISTRY[("mistral", "sparse", _loss)] = (
        MistralBiSparse if _loss == "nce"
        else _variant(MistralBiSparse, _loss, f"MistralBiSparseFor{_loss}"))
    MODEL_REGISTRY[("mistral", "dense", _loss)] = (
        MistralBiDense if _loss == "nce"
        else _variant(MistralBiDense, _loss, f"MistralBiDenseFor{_loss}"))


def encoder_class(model_dir: str, pooling: str):
    """The eval CLIs' dispatch: ``model_type`` from the directory's
    ``config.json`` picks the family (an adapter directory's config, or
    none, means Llama)."""
    model_type = "llama"
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.isdir(model_dir) and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
        model_type = cfg.get("model_type", "llama")
        if "peft_type" in cfg:
            model_type = "llama"
    if model_type not in ("qwen2", "mistral"):
        model_type = "llama"
    return MODEL_REGISTRY[(model_type, pooling, "nce")]


def load_encoder(model_dir: str, pooling: str,
                 lora_name_or_path: Optional[str] = None, device="cuda",
                 **config_overrides) -> LLM2Retriever:
    """The eval CLIs' loading: a LoRA directory (``adapter_config.json``)
    loads its base model and merges it; otherwise the checkpoint, merged
    with ``lora_name_or_path`` when given."""
    cls = encoder_class(model_dir, pooling)
    if os.path.isdir(model_dir) and os.path.exists(
            os.path.join(model_dir, "adapter_config.json")):
        return cls.load_from_lora(model_dir, device=device,
                                  **config_overrides)
    if lora_name_or_path:
        return cls.load(model_dir, lora_name_or_path=lora_name_or_path,
                        device=device, **config_overrides)
    return cls.load(model_dir, device=device, **config_overrides)


def load_tokenizer(name_or_path: str):
    """The checkpoint directory's tokenizer, loaded by ``transformers``
    (imported here: the package does not need it otherwise), from a
    directory resolved as the model's is: nothing is fetched."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(_resolve_model_dir(name_or_path))
