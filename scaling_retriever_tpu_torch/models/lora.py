"""LoRA configuration and merge (port of models/lora.py; the peft adapter
file I/O, and the adapter fields of LoraConfig it reads and writes, are not
ported yet).

Factors keep the JAX package's stacked layout, as torch tensors:
``{"layers": {"attn"|"mlp": {name: {"a": [L, in, r], "b": [L, r, out]}}}}``
with names wq/wk/wv/wo/wg/wu/wd.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    lora_alpha: int = 32

    @property
    def scaling(self) -> float:
        return self.lora_alpha / self.r


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
