"""Inference collators (port of the collection collators of
data/collators.py): (id, text) batches tokenized into numpy arrays.

The tokenizer is any callable with the Hugging Face call protocol:
``tokenizer(texts, truncation=True, max_length=..., padding="longest" or
"max_length", pad_to_multiple_of=..., return_attention_mask=True)``
returning ``input_ids`` and ``attention_mask``. ``fixed_length`` pads to
``max_length`` (one tensor shape per length). The training collators wait
for the training slice (ROADMAP A11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _tokenize(tokenizer, texts, max_length: int,
              pad_to_multiple_of: Optional[int], fixed_length: bool) -> dict:
    enc = tokenizer(list(texts), truncation=True, max_length=max_length,
                    padding="max_length" if fixed_length else "longest",
                    pad_to_multiple_of=None if fixed_length
                    else pad_to_multiple_of,
                    return_attention_mask=True)
    return {
        "input_ids": np.asarray(enc["input_ids"], np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], np.int32),
    }


class LlamaSparseCollectionCollator:
    """(ids, texts) batches → {"input_ids", "attention_mask", "ids"}."""

    def __init__(self, tokenizer, max_length: int,
                 pad_to_multiple_of: Optional[int] = 8,
                 fixed_length: bool = False):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.pad_to_multiple_of = pad_to_multiple_of
        self.fixed_length = fixed_length

    def __call__(self, batch):
        ids, texts = [list(x) for x in zip(*batch)]
        return {**_tokenize(self.tokenizer, texts, self.max_length,
                            self.pad_to_multiple_of, self.fixed_length),
                "ids": ids}


LlamaDenseCollectionCollator = LlamaSparseCollectionCollator
LlamaHybridCollectionCollator = LlamaSparseCollectionCollator
T5SparseCollectionCollator = LlamaSparseCollectionCollator
