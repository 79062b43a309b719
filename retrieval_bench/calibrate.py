"""The builder's tool for defining a cell, never run by a check: runs of
one cell in one process, over several seeds (and optionally several
offered rates, for a knee sweep), each printing its end-to-end numbers,
the comparison numbers and, with ``--control``, the control's numbers on
the same sample, one JSON line each.

    python3 -m retrieval_bench.calibrate --workload <cell> \
        --seeds 1,2,3 --seconds 5 [--rates 1000,2000] [--control]
"""

from __future__ import annotations

import argparse
import json
import time

from retrieval_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", default=None)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        run.log("no CUDA device")
        return 2
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, _, traffic = run.cell_spec(bench, args.workload)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates
             else [traffic.get("rate_qps")])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    for rate in rates:
        tr = dict(traffic)
        if rate is not None:
            tr["rate_qps"] = rate
        for seed in [int(s) for s in args.seeds.split(",")]:
            t = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(dev)
            res = run.run_cell(bench, args.workload, seed, args.seconds,
                               False, dev, control=args.control,
                               traffic=tr, limits={})
            out = res["out"]
            print(json.dumps({
                "workload": args.workload, "rate": rate, "seed": seed,
                "e2e": {k: v for k, v in out["e2e"].items()
                        if k != "setup_s"},
                "attempted": out["attempted"], "failed": out["failed"],
                "drain_s": out.get("drain_s"),
                "memory_peak_bytes": out["memory_peak_bytes"],
                "numbers": out["numbers"], "control": out["control"],
                "wall_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
