"""LoRA: configuration, initialization, merge, and peft adapter files
(port of models/lora.py).

Factors keep the JAX package's stacked layout, as torch tensors:
``{"layers": {"attn"|"mlp": {name: {"a": [L, in, r], "b": [L, r, out]}}}}``
with names wq/wk/wv/wo/wg/wu/wd. peft stores A as ``[r, in]`` and B as
``[out, r]`` per layer; ``load_adapter`` and ``save_adapter`` transpose
between the two. Adapter files are read and written with the port's own
safetensors reader and writer (``models/safetensors_io.py``).

    python -m scaling_retriever_tpu_torch.models.lora \\
        --input_dir <mntp adapter> --output_dir <bimodel adapter>

rewrites an MNTP-wrapped adapter's keys for the bare bidirectional model
(``rewrite_mntp_to_bimodel``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Optional, Sequence

import torch

from scaling_retriever_tpu_torch.models import safetensors_io
from scaling_retriever_tpu_torch.models.config import ModelConfig

# peft module name -> (group, param name) in the stacked layout
TARGET_MAP = {
    "q_proj": ("attn", "wq"),
    "k_proj": ("attn", "wk"),
    "v_proj": ("attn", "wv"),
    "o_proj": ("attn", "wo"),
    "gate_proj": ("mlp", "wg"),
    "up_proj": ("mlp", "wu"),
    "down_proj": ("mlp", "wd"),
}
DEFAULT_TARGET_MODULES = ("q_proj", "v_proj", "o_proj", "k_proj",
                          "down_proj", "up_proj", "gate_proj")

_LAYER_RE = re.compile(
    r"layers\.(\d+)\.(self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight$")
ADAPTER_FILE = "adapter_model.safetensors"
ADAPTER_BIN = "adapter_model.bin"
ADAPTER_CONFIG = "adapter_config.json"


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.0
    target_modules: Sequence[str] = DEFAULT_TARGET_MODULES
    base_model_name_or_path: Optional[str] = None
    base_model_class: str = "LlamaBiForMNTP"  # or LlamaBiModel / Qwen2Bi*

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r

    @classmethod
    def from_adapter_dir(cls, adapter_dir: str) -> "LoraConfig":
        with open(os.path.join(adapter_dir, ADAPTER_CONFIG)) as f:
            cfg = json.load(f)
        auto = cfg.get("auto_mapping") or {}
        return cls(
            r=cfg["r"],
            lora_alpha=cfg["lora_alpha"],
            lora_dropout=cfg.get("lora_dropout", 0.0),
            target_modules=tuple(cfg.get("target_modules")
                                 or DEFAULT_TARGET_MODULES),
            base_model_name_or_path=cfg.get("base_model_name_or_path"),
            base_model_class=auto.get("base_model_class", "LlamaBiForMNTP"),
        )

    def to_adapter_config(self) -> dict:
        return {
            "peft_type": "LORA",
            "auto_mapping": {
                "base_model_class": self.base_model_class,
                "parent_library": "scaling_retriever_tpu_torch.models.encoder",
            },
            "base_model_name_or_path": self.base_model_name_or_path,
            "r": self.r,
            "lora_alpha": self.lora_alpha,
            "lora_dropout": self.lora_dropout,
            "target_modules": list(self.target_modules),
            "bias": "none",
            "inference_mode": False,
            "task_type": None,
        }


def _fan_in_out(config: ModelConfig) -> dict:
    h, q, kv, i = (config.hidden_size, config.q_dim, config.kv_dim,
                   config.intermediate_size)
    return {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (q, h), "gate_proj": (h, i), "up_proj": (h, i),
            "down_proj": (i, h)}


def init_lora_params(model_config: ModelConfig, lora_config: LoraConfig,
                     generator: torch.Generator, dtype=torch.float32,
                     device="cuda") -> dict:
    """peft's init: A ~ kaiming_uniform(a=sqrt(5)), i.e. U(+-1/sqrt(fan_in)),
    and B = 0, stacked over layers. ``generator`` lives on ``device``; the
    draws differ from the JAX package's for any seed."""
    nl, r = model_config.num_hidden_layers, lora_config.r
    shapes = _fan_in_out(model_config)
    layers: dict = {"attn": {}, "mlp": {}}
    for mod in lora_config.target_modules:
        if mod not in TARGET_MAP:
            raise NotImplementedError(f"LoRA target {mod!r}")
        group, name = TARGET_MAP[mod]
        fan_in, fan_out = shapes[mod]
        bound = 1.0 / math.sqrt(fan_in)
        a = torch.rand((nl, fan_in, r), generator=generator, device=device,
                       dtype=torch.float32) * (2 * bound) - bound
        layers[group][name] = {
            "a": a.to(dtype),
            "b": torch.zeros((nl, r, fan_out), dtype=dtype, device=device),
        }
    return {"layers": layers}


@torch.no_grad()
def merge_lora(model, lora: dict, lora_config: LoraConfig):
    """Fold the LoRA factors into ``model``'s projection weights IN PLACE
    (peft ``merge_and_unload``; in place because a second copy of a 1B
    model's weights is what the merge would otherwise cost) and return it.
    The delta is formed in float32, as in the reference."""
    scale = lora_config.scaling
    for mods in lora.get("layers", {}).values():
        for name, fac in mods.items():
            for i, layer in enumerate(model.layers):
                w = getattr(layer, name).weight              # [out, in]
                delta = (fac["a"][i].float() @ fac["b"][i].float()) * scale
                w.copy_((w.float() + delta.T.to(w.device)).to(w.dtype))
    return model


# ---------------------------------------------------------------------------
# peft adapter files
# ---------------------------------------------------------------------------

def _normalize_adapter_key(key: str) -> str:
    """'base_model.model(.model)*.layers.N...' → 'layers.N...': the
    MNTP-wrapped layout (``base_model.model.model.layers``) and the
    BiModel layout (``base_model.model.layers``) both load."""
    if key.startswith("base_model."):
        key = key[len("base_model."):]
    while key.startswith("model."):
        key = key[len("model."):]
    return key


def read_adapter_tensors(adapter_dir: str) -> dict:
    """Raw adapter tensors (CPU) from ``adapter_model.safetensors``, or
    from a torch ``adapter_model.bin`` where there is none."""
    st_path = os.path.join(adapter_dir, ADAPTER_FILE)
    if os.path.exists(st_path):
        return safetensors_io.load_file(st_path)
    return torch.load(os.path.join(adapter_dir, ADAPTER_BIN),
                      map_location="cpu", weights_only=True)


def load_adapter(adapter_dir: str, model_config: ModelConfig,
                 dtype=torch.float32, device="cuda") -> tuple[dict, LoraConfig]:
    """Read a peft LoRA adapter directory into the stacked layout on
    ``device``."""
    lora_config = LoraConfig.from_adapter_dir(adapter_dir)
    tensors = read_adapter_tensors(adapter_dir)
    nl = model_config.num_hidden_layers
    per_mod: dict = {}
    for raw_key, val in tensors.items():
        m = _LAYER_RE.search(_normalize_adapter_key(raw_key))
        if m is None:
            continue  # non-layer adapter weights (modules_to_save)
        layer_idx, mod, ab = int(m.group(1)), m.group(3), m.group(4)
        slot = per_mod.setdefault(TARGET_MAP[mod], {"a": {}, "b": {}})
        # peft A [r, in], B [out, r] → a [in, r], b [r, out]
        slot["a" if ab == "A" else "b"][layer_idx] = val.T
    layers: dict = {"attn": {}, "mlp": {}}
    for (group, name), slot in per_mod.items():
        if len(slot["a"]) != nl or len(slot["b"]) != nl:
            raise ValueError(f"adapter {adapter_dir}: {name} has "
                             f"{len(slot['a'])}/{len(slot['b'])} A/B layers, "
                             f"the model {nl}")
        layers[group][name] = {
            ab: torch.stack([slot[ab][i] for i in range(nl)]).to(
                device=device, dtype=dtype)
            for ab in ("a", "b")}
    return {"layers": layers}, lora_config


def save_adapter(lora: dict, lora_config: LoraConfig, save_dir: str) -> None:
    """Write a peft-compatible adapter: f32 ``adapter_model.safetensors``
    and ``adapter_config.json``."""
    os.makedirs(save_dir, exist_ok=True)
    # MNTP-class adapters nest one extra "model." (LlamaBiForMNTP.model)
    inner = "model.model" if "MNTP" in lora_config.base_model_class else "model"
    inv_target = {v: k for k, v in TARGET_MAP.items()}
    scope_of = {"attn": "self_attn", "mlp": "mlp"}
    tensors = {}
    for group, mods in lora["layers"].items():
        for name, fac in mods.items():
            mod = inv_target[(group, name)]
            a, b = fac["a"].float(), fac["b"].float()
            for i in range(a.shape[0]):
                prefix = f"base_model.{inner}.layers.{i}.{scope_of[group]}.{mod}"
                tensors[f"{prefix}.lora_A.weight"] = a[i].T.contiguous()
                tensors[f"{prefix}.lora_B.weight"] = b[i].T.contiguous()
    safetensors_io.save_file(tensors, os.path.join(save_dir, ADAPTER_FILE))
    with open(os.path.join(save_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(lora_config.to_adapter_config(), f, indent=2)


def rewrite_mntp_to_bimodel(adapter_dir: str, out_dir: str,
                            model_type: str = "llama") -> None:
    """Rename MNTP-wrapped adapter keys (``base_model.model.model.``) so
    the adapter attaches to the bare bidirectional model, and relabel its
    base model class. This package's loader takes both layouts; the tool
    is for other loaders."""
    os.makedirs(out_dir, exist_ok=True)
    tensors = safetensors_io.load_file(os.path.join(adapter_dir, ADAPTER_FILE))
    renamed = {k.replace("base_model.model.model.", "base_model.model."): v
               for k, v in tensors.items()}
    safetensors_io.save_file(renamed, os.path.join(out_dir, ADAPTER_FILE))
    with open(os.path.join(adapter_dir, ADAPTER_CONFIG)) as f:
        cfg = json.load(f)
    mntp_cls = "LlamaBiForMNTP" if model_type == "llama" else "Qwen2BiForMNTP"
    bi_cls = "LlamaBiModel" if model_type == "llama" else "Qwen2BiModel"
    if cfg.get("auto_mapping", {}).get("base_model_class") == mntp_cls:
        cfg["auto_mapping"]["base_model_class"] = bi_cls
    with open(os.path.join(out_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(cfg, f, indent=2)


def _rewrite_cli(argv=None) -> None:
    """Rewrite an MNTP-wrapped LoRA adapter for the bare bidirectional
    model."""
    import argparse

    p = argparse.ArgumentParser(description=_rewrite_cli.__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_type", default=None,
                   help="llama|qwen2; inferred from adapter_config by default")
    ns = p.parse_args(argv)
    model_type = ns.model_type
    if model_type is None:
        with open(os.path.join(ns.input_dir, ADAPTER_CONFIG)) as f:
            cls_name = (json.load(f).get("auto_mapping") or {}).get(
                "base_model_class", "LlamaBiForMNTP")
        model_type = "qwen2" if cls_name.startswith("Qwen2") else "llama"
    rewrite_mntp_to_bimodel(ns.input_dir, ns.output_dir, model_type)
    print(f"rewrote {ns.input_dir} -> {ns.output_dir} ({model_type})")


if __name__ == "__main__":
    _rewrite_cli()
