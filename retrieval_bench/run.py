"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m retrieval_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the checkout's root:
the cell's configuration (``retrieval_bench/configs/<config>.json``), the
architecture module it names (``retrieval_bench/archs/<arch>.py``: the
port's encoder over the benchmark's weights, the plain reference and the
FLOP count; its interface is in ``archs/bidir_decoder.py``), its traffic
mix (``retrieval_bench/traffic/<mix>.json``, whose ``kind`` names
the driver in ``retrieval_bench/kinds/``), its limits
(``retrieval_bench/limits/<cell>.json``) and each per-layer metric's reader
(``retrieval_bench/metrics/<metric>.py``). A run makes its inputs from
``--seed``, warms the cell's shapes, measures for ``--seconds``, frees the
program, checks a sample of what the window produced against the plain
reference, and prints one JSON line last on stdout. ``--trace 1`` runs
the window under ``torch.profiler`` and reports the per-layer metrics
instead of the end-to-end ones.

Without a CUDA card, outside a checkout of the port, or with JAX loaded
at the end, it exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "scaling_retriever_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "scaling_retriever_tpu")
CACHE = os.path.join(ROOT, ".rb_cache")


def set_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(root, ".rb_cache")
    os.environ["SRT_BUILD_DIR"] = os.path.join(cache, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file whose name is a metric's (dots and dashes
    included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_entry(bench: dict, name: str) -> dict:
    return next(c for c in bench["configs"] if c["name"] == name)


def load_arch(root: str, config: dict, conf: dict, kind):
    """The architecture module that the configuration ``conf`` (whose
    entry in BENCHMARK.json is ``config``) names under ``"arch"``, loaded
    from ``retrieval_bench/archs/<arch>.py`` under ``root``, holding every
    function the traffic's ``kind`` module lists in its ``ARCH``. There is
    no default: a missing key, file or function ends the run."""
    where = f"configuration {config['name']} ({config['file']})"
    if "arch" not in conf:
        raise SystemExit(f"{where} names no \"arch\": add the key, naming "
                         f"a module retrieval_bench/archs/<arch>.py")
    rel = os.path.join("retrieval_bench", "archs", f"{conf['arch']}.py")
    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        raise SystemExit(f"{where} names arch {conf['arch']!r}, but {rel} "
                         f"does not exist")
    mod = load_file(path, f"rb_arch_{conf['arch']}")
    missing = [f for f in getattr(kind, "ARCH", ()) if not hasattr(mod, f)]
    if missing:
        raise SystemExit(f"{rel}, the arch of {where}, defines no "
                         f"{', '.join(missing)}, which the "
                         f"{kind.__name__.rsplit('.', 1)[-1]} kind needs")
    return mod


def cell_spec(bench: dict, cell: str, root: str = ROOT) -> tuple:
    """(workload entry, configuration file, traffic file) of ``cell``."""
    wl = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if wl is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = load_json(root, config_entry(bench, wl["config"])["file"])
    traffic = load_json(root, "retrieval_bench", "traffic",
                        f"{wl['traffic']}.json")
    return wl, conf, traffic


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones,
    or with ``trace`` its per-layer ones (listed for it, or moving an
    end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    summary: object = None


@dataclasses.dataclass
class Context:
    """What a kind's ``run`` gets; ``arch`` is the configuration's
    architecture module (``run.load_arch``)."""

    cell: str
    conf: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    arch: object
    control: bool = False
    log: Callable = log
    scratch: str = CACHE

    def stage(self, name: str) -> None:
        """Log how far set-up has come, in seconds since the process
        started."""
        self.log(f"set-up: {name} at {time.perf_counter() - T_START:.2f} s")

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window, as the span ``rb.window``; traced under
        ``--trace 1``."""
        from retrieval_bench.trace import WINDOW_SPAN, Trace, span

        w = Window()
        tracer = Trace() if self.trace else contextlib.nullcontext()
        with tracer:
            with span(WINDOW_SPAN):
                t0 = time.perf_counter()
                yield w
                self.sync()
                w.seconds = time.perf_counter() - t0
        if self.trace:
            w.summary = tracer.summarize()

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, root: str = ROOT, control: bool = False,
             conf: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None) -> dict:
    """One run of ``cell``: its kind's numbers, its metrics by name and
    the judgment of its comparisons. ``conf``, ``traffic`` and ``limits``
    replace the cell's files (tests run tiny sizes on the CPU)."""
    from retrieval_bench import check

    wl, conf_f, traffic_f = cell_spec(bench, cell, root)
    conf, traffic = conf or conf_f, traffic or traffic_f
    kind = importlib.import_module(f"retrieval_bench.kinds.{traffic['kind']}")
    arch = load_arch(root, config_entry(bench, wl["config"]), conf, kind)
    ctx = Context(cell, conf, traffic, seed, seconds, trace, device, arch,
                  control)
    out = kind.run(ctx)
    out["e2e"]["setup_s"] = out["window_start"] - T_START
    entries = metrics_for(bench, cell, trace)
    metrics = {}
    for m in entries:
        if not trace:
            value = out["e2e"].get(m["name"])
        else:
            reader = load_file(os.path.join(root, "retrieval_bench",
                                            "metrics", f"{m['name']}.py"),
                               f"rb_metric_{len(metrics)}")
            value = reader.read(out["record"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lim = limits if limits is not None else check.limits(root, cell)
    correct, compared = check.judge(out["numbers"], lim)
    return {"wl": wl, "out": out, "metrics": metrics, "correct": correct,
            "compared": compared}


def forbidden_loaded(names=None) -> list:
    """The forbidden packages among loaded modules (``sys.modules`` by
    default), by whole top-level name."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def result_line(res: dict, device, trace: bool) -> dict:
    import torch

    out = res["out"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": res["wl"]["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": res["metrics"],
            "device": dev}
    summary = out["record"].get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["compared"] = res["compared"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, _, _ = cell_spec(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    port = importlib.import_module(PORT)
    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        log(f"{PORT} was loaded from {port.__file__}, not this checkout")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    bad = forbidden_loaded()
    if bad:
        log(f"modules that may not be loaded: {bad}")
        return 3
    line = result_line(res, device, bool(args.trace))
    control = res["out"].get("control")
    if control:
        log(f"control numbers: {json.dumps(control)}")
    for name, c in res["compared"].items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
