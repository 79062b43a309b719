"""What the DeepSeek-V2 cell's check does not print, from one untraced run
of it on the card: the window's expert load (max / mean slots an expert,
by MoE layer, from ``DeepseekV2BiForMNTP.expert_load()`` reset when the
frontend starts serving), the share of (token, layer) routings on which
the port and the plain reference choose different experts over a sample
of the cell's texts, and the run's peak card memory. Prints one JSON
line.

    python3 scripts/deepseek_v2_report.py --seed N [--seconds 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from retrieval_bench import gen, run  # noqa: E402
from retrieval_bench.reference import deepseek_v2 as reference  # noqa: E402

CELL = "deepseek-v2-lite.text-long"


def routing_share(model, m: dict, seed: int, tr: dict, dev) -> float:
    """Share of the sample's real (token, MoE layer) pairs whose top-k
    expert sets differ between the port (eager, bf16) and the
    reference (float32)."""
    bank = gen.word_bank(m["vocab_size"], tr["word_bank"], seed)
    texts = gen.texts(tr["words"], tr["sample"], bank, seed, stream=11)
    tok = gen.StandInTokenizer(m["vocab_size"], tr["length_rungs"])
    ids, mask = tok(texts)
    got = []
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, inp, out: got.append(out[1].view(*ids.shape, -1)))
        for layer in model.params.layers if layer.is_moe]
    model.encode(ids, mask)
    for h in hooks:
        h.remove()
    want = []
    lists = [tok.tokens(t) for t in texts]
    reference.sparse_reps(m, seed, lists, dev, routes=want)
    differ = total = 0
    for g_, w_ in zip(got, want):
        g_ = g_.sort(-1).values.cpu()
        w_ = w_.sort(-1).values.cpu()
        for i, t in enumerate(lists):
            a = g_[i, ids.shape[1] - len(t):]
            b = w_[i, :len(t)]
            differ += int((a != b).any(-1).sum())
            total += len(t)
    return differ / total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    run.set_cache_dirs()
    from scaling_retriever_tpu_torch.serving import text_frontend

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, conf, tr = run.cell_spec(bench, CELL)
    arch = run.load_file(os.path.join(run.ROOT, "retrieval_bench", "archs",
                                      "deepseek_v2.py"), "rb_arch_report")
    kept = {}
    build = arch.build_encoder

    def build_kept(*a, **kw):
        kept["model"] = build(*a, **kw)
        return kept["model"]

    start = text_frontend.QueryEncoderFrontend.start

    def start_reset(fe):
        kept["model"].params.reset_expert_load()
        return start(fe)

    text_frontend.QueryEncoderFrontend.start = start_reset
    real_load = run.load_arch

    def load_arch(*a, **kw):
        mod = real_load(*a, **kw)
        mod.build_encoder = build_kept
        return mod

    run.load_arch = load_arch
    res = run.run_cell(bench, CELL, args.seed, args.seconds, False, dev)
    load = kept["model"].params.expert_load().numpy().astype(np.float64)
    per_layer = load.max(1) / load.mean(1)
    share = routing_share(kept["model"], conf["model"], args.seed, tr, dev)
    print(json.dumps({
        "card": torch.cuda.get_device_name(dev), "seed": args.seed,
        "correct": res["correct"], "compared": res["compared"],
        "memory_peak_bytes": res["out"]["memory_peak_bytes"],
        "window_slots": int(load.sum()),
        "expert_load_max_over_mean": {
            "all_layers": float(load.max() / load.mean()),
            "by_layer_min": float(per_layer.min()),
            "by_layer_median": float(np.median(per_layer)),
            "by_layer_max": float(per_layer.max())},
        "routing_differ_share": share}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
