"""Average perf.json over the 13-dataset BEIR suite (port of
evaluation/beir_results.py).

Run: ``python -m scaling_retriever_tpu_torch.evaluation.beir_results
--beir_eval_dir DIR``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

BEIR_DATASETS = [
    "arguana", "fiqa", "nfcorpus", "quora", "scidocs", "scifact",
    "trec-covid", "webis-touche2020", "climate-fever", "dbpedia-entity",
    "fever", "hotpotqa", "nq",
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--beir_eval_dir", required=True)
    parser.add_argument("--datasets", nargs="*", default=BEIR_DATASETS)
    args = parser.parse_args(argv)

    all_perf: dict[str, list] = {}
    missing = []
    for ds in args.datasets:
        perf_path = os.path.join(args.beir_eval_dir, ds, "perf.json")
        if not os.path.exists(perf_path):
            missing.append(ds)
            continue
        with open(perf_path) as f:
            perf = json.load(f)
        for k, v in perf.items():
            all_perf.setdefault(k, []).append(v)

    avg = {k: float(np.mean(v)) for k, v in all_perf.items()}
    avg["num_datasets"] = len(args.datasets) - len(missing)
    if missing:
        avg["missing"] = missing
    out_path = os.path.join(args.beir_eval_dir, "average_perf.json")
    with open(out_path, "w") as f:
        json.dump(avg, f, indent=4)
    print(json.dumps(avg, indent=2))
    return avg


if __name__ == "__main__":
    main()
