"""The harness finds a configuration, a traffic mix, a per-layer metric
and a cell's limits by name: adding them takes new files and new entries
in BENCHMARK.json, and no edit to a file that is there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import torch

from retrieval_bench import run
from retrieval_bench.tests.helpers import SEED, tiny_conf

READER = '''"""Texts a tile, from the frontend's counters."""


def read(rec):
    c = rec["counters"]
    return c["n_texts"] / c["n_encode_batches"]
'''


def digest(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(os.path.join(root, "retrieval_bench")):
        if "__pycache__" in d:
            continue
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_config_mix_and_metric_added_as_files_need_no_edit(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "retrieval_bench"),
                    os.path.join(root, "retrieval_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    old = json.loads(json.dumps(bench))
    rb = os.path.join(root, "retrieval_bench")
    conf = dict(tiny_conf("qwen2-1.5b"), source="a tiny test model")
    with open(os.path.join(rb, "configs", "tiny-qwen.json"), "w") as f:
        json.dump(conf, f)
    mix = run.load_json(run.ROOT, "retrieval_bench", "traffic",
                        "text-short.json")
    mix.update(rate_qps=60, t_sparse=16, sample=4, word_bank=128)
    with open(os.path.join(rb, "traffic", "tiny-text.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(rb, "metrics", "texts.tiny.py"), "w") as f:
        f.write(READER)
    limits = {k: 1.0 for k in ("rep_weight_err", "rep_rank_gap",
                               "engine_score_err", "engine_rank_gap")}
    with open(os.path.join(rb, "limits", "tiny-qwen.tiny-text.json"),
              "w") as f:
        json.dump({"limits": dict(limits, tokens_mismatch=0)}, f)
    bench["configs"].append({"name": "tiny-qwen", "source": "test",
                             "file": "retrieval_bench/configs/tiny-qwen.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-qwen.tiny-text",
                               "config": "tiny-qwen", "traffic": "tiny-text",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "text_p50_ms" == m["name"]:
            m["workloads"].append("tiny-qwen.tiny-text")
    bench["per_layer"].append({"name": "texts.tiny", "unit": "texts/tile",
                               "better": "higher", "source": "program_counter",
                               "layer": "text broker", "moves": "text_p50_ms",
                               "workloads": ["tiny-qwen.tiny-text"]})
    for key in ("configs", "workloads", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before

    res = run.run_cell(bench, "tiny-qwen.tiny-text", SEED, 0.3, True,
                       torch.device("cpu"), root=root)
    assert res["metrics"]["texts.tiny"]["value"] >= 1.0
    assert res["correct"], res["compared"]
    plain = run.run_cell(bench, "tiny-qwen.tiny-text", SEED, 0.3, False,
                         torch.device("cpu"), root=root)
    assert set(plain["metrics"]) == {"setup_s", "text_p50_ms"}
