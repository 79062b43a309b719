"""The dense embedding writer (port of the dense half of index/indexer.py:
``store_embs`` and the ``plan.json`` reader). ``SparseIndexer`` is not
ported yet (ROADMAP A8).

Batches come from any iterable yielding ``{"input_ids", "attention_mask",
"ids"}`` (the collator convention). The artifacts are the reference's,
byte for byte: ``embs_{rank}_{chunk}.npy`` (f32, or f16 with
``use_fp16``), ``ids_{rank}_{chunk}.npy`` (a pickled object array) and a
``plan.json`` manifest.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np
import torch


def store_embs(model, collection_loader: Iterable, local_rank: int,
               out_dir: str, chunk_size: int = 2_000_000,
               use_fp16: bool = False, world_size: int = 1) -> None:
    """Encode a corpus shard and write its embedding chunks (a chunk every
    ``chunk_size // batch_size`` batches) and ``plan.json``."""
    os.makedirs(out_dir, exist_ok=True)
    write_freq = max(1, chunk_size // _infer_batch_size(collection_loader))

    embs, ids = [], []
    chunk_idx = 0
    for i, batch in enumerate(collection_loader):
        reps = torch.as_tensor(model.encode(batch["input_ids"],
                                            batch["attention_mask"]))
        reps = reps.float().cpu().numpy()
        embs.append(reps.astype(np.float16) if use_fp16 else reps)
        ids.extend(batch["ids"])
        if (i + 1) % write_freq == 0:
            _flush(out_dir, local_rank, chunk_idx, embs, ids)
            embs, ids = [], []
            chunk_idx += 1
    if embs:
        _flush(out_dir, local_rank, chunk_idx, embs, ids)
        chunk_idx += 1

    plan = {"nranks": world_size, "num_chunks": chunk_idx, "index_path": None}
    with open(os.path.join(out_dir, "plan.json"), "w") as f:
        json.dump(plan, f)


def _infer_batch_size(loader) -> int:
    return getattr(loader, "batch_size", 128) or 128


def _flush(out_dir: str, rank: int, chunk_idx: int, embs: list,
           ids: list) -> None:
    arr = np.concatenate(embs, axis=0)
    np.save(os.path.join(out_dir, f"embs_{rank}_{chunk_idx}.npy"), arr)
    np.save(os.path.join(out_dir, f"ids_{rank}_{chunk_idx}.npy"),
            np.asarray(ids, dtype=object), allow_pickle=True)


def obtain_doc_vec_dir_files(doc_embed_dir: str
                             ) -> tuple[list[str], list[str]]:
    """Read plan.json → ordered (emb_files, id_files)."""
    with open(os.path.join(doc_embed_dir, "plan.json")) as f:
        plan = json.load(f)
    emb_files, id_files = [], []
    for rank in range(plan["nranks"]):
        for chunk in range(plan["num_chunks"]):
            emb = os.path.join(doc_embed_dir, f"embs_{rank}_{chunk}.npy")
            idf = os.path.join(doc_embed_dir, f"ids_{rank}_{chunk}.npy")
            if os.path.exists(emb):
                emb_files.append(emb)
                id_files.append(idf)
    return emb_files, id_files
