"""Where one eager text tile of a benchmark configuration spends its
device time, by aten op and by kernel: the encoder at the configuration's
published widths with the benchmark's bf16 weights for ``--seed``, one
``--texts`` x ``--positions`` tile of left-padded rows (one full, the rest
half to full length) through the frontend's tile function (ids to top-T),
eager, with grad off, profiled over ``--reps`` tiles.

Prints each aten op's own device time (the kernels it launched itself) a
tile, each kernel's, the attention kernel's launches over one tile, and
one JSON line last (also written to ``--out``). Needs the card:

    python3 scripts/tile_ops.py --config mistral-7b --texts 64 --positions 64 --out tile_ops.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from retrieval_bench.archs import bidir_decoder  # noqa: E402
from scaling_retriever_tpu_torch.ops import cuda_lib  # noqa: E402
from scaling_retriever_tpu_torch.serving.text_frontend import (  # noqa: E402
    make_encode_fn_handoff)


def self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mistral-7b")
    ap.add_argument("--texts", type=int, default=64)
    ap.add_argument("--positions", type=int, default=64)
    ap.add_argument("--t", type=int, default=64, help="top-T a text")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_ops.py profiles the card; none is visible")
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "retrieval_bench", "configs",
                           f"{args.config}.json")) as f:
        conf = json.load(f)
    enc = bidir_decoder.build_encoder(conf, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    n, pos = args.texts, args.positions
    lens = rng.integers(pos // 2, pos + 1, n)
    lens[0] = pos
    ids = np.zeros((n, pos), np.int32)
    mask = np.zeros((n, pos), np.int32)
    for i, m in enumerate(lens):
        ids[i, pos - m:] = rng.integers(2, enc.config.vocab_size, m)
        mask[i, pos - m:] = 1
    encode = make_encode_fn_handoff(enc, args.t)
    with torch.no_grad():
        for _ in range(2):
            encode(ids, mask)
        torch.cuda.synchronize()
        before = dict(cuda_lib.LAUNCHES)
        encode(ids, mask)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()
                    if v != before[k]}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                encode(ids, mask)
            torch.cuda.synchronize()
    ops, kernels = {}, {}
    events = prof.key_averages()
    # a program span is a CPU range and a device one of the same name
    cpu_keys = {e.key for e in events if e.device_type != DeviceType.CUDA}
    for e in events:
        ms = self_device_us(e) / 1e3 / args.reps
        if ms <= 0 or (e.device_type == DeviceType.CUDA
                       and e.key in cpu_keys):
            continue
        side = kernels if e.device_type == DeviceType.CUDA else ops
        side[e.key] = side.get(e.key, 0.0) + ms
    card = (f"{torch.cuda.get_device_name(dev)}, "
            f"{torch.cuda.device_count()} visible")
    for name, table in (("op", ops), ("kernel", kernels)):
        for key, ms in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"{name} {ms:9.4f} ms  {key}")
    result = {"config": args.config, "tile": f"{n}x{pos}", "card": card,
              "device_ms": sum(kernels.values()), "ops_ms": ops,
              "kernels_ms": kernels, "launches": launches}
    print(f"{args.config} {n}x{pos} tile: {result['device_ms']:.3f} ms of "
          f"device time, launches {launches}; card {card}")
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
