"""A configuration names its architecture module (``archs/<arch>.py``),
and the kinds reach the model, its weights, its plain reference and its
FLOP count only through it: every configuration resolves, the decoder
family's module builds the weights and counts the FLOPs as before, a
non-Llama architecture's cell is added as new files alone, the run is
judged against the configuration's own reference, and a bad ``arch``
ends the run."""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil

import pytest
import torch

from retrieval_bench import check, flops, gen, run
from retrieval_bench.archs import bidir_decoder
from retrieval_bench.tests.helpers import SEED, tiny_conf, tiny_traffic
from retrieval_bench.tests.test_rb_spec import digest

TOY_ARCH = '''"""A toy non-Llama sparse encoder: a bag of embeddings through
one GELU projection to the SPLADE head, no attention and no position."""

import torch

from retrieval_bench import gen
from retrieval_bench.reference.decoder import exact_f32, linear


def _weights(m, seed, device, dtype):
    v, h = m["vocab_size"], m["hidden_size"]
    return gen.draw([("embed", (v, h), "mat"), ("proj", (h, h), "mat"),
                     ("head", (v, h), "mat")], seed, 0, device, dtype)


def _reps(w, ids, keep, precision="f32"):
    x = linear(w["embed"][ids], w["proj"], precision)
    x = torch.nn.functional.gelu(x)
    logits = linear(x, w["head"], precision)
    logits = logits.masked_fill(~keep[:, :, None], float("-inf"))
    return torch.log1p(torch.relu(logits.amax(dim=1)))


class ToyEncoder:
    def __init__(self, w, device):
        from scaling_retriever_tpu_torch.models.tile_graphs import TileGraphs

        self.w, self.device = w, torch.device(device)
        self.tile_graphs = TileGraphs()

    @torch.no_grad()
    def encode(self, ids, mask):
        ids = torch.as_tensor(ids, device=self.device).long()
        keep = torch.as_tensor(mask, device=self.device) > 0
        return _reps(self.w, ids, keep).float()


def build_encoder(conf, seed, device, **overrides):
    return ToyEncoder(_weights(conf["model"], seed, device, torch.bfloat16),
                      device)


def sparse_reps(m, seed, token_lists, device, precision="f32"):
    with exact_f32():
        w = {k: v.float() for k, v in
             _weights(m, seed, device, torch.bfloat16).items()}
        s = max(len(t) for t in token_lists)
        ids = torch.zeros((len(token_lists), s), dtype=torch.long)
        keep = torch.zeros((len(token_lists), s), dtype=torch.bool)
        for i, t in enumerate(token_lists):
            ids[i, :len(t)] = torch.tensor(t)
            keep[i, :len(t)] = True
        return _reps(w, ids.to(device), keep.to(device), precision)


def encode_flops(m, n_tokens):
    h = m["hidden_size"]
    return float(2 * n_tokens * (h * h + m["vocab_size"] * h))
'''

SCALED_ARCH = '''"""The decoder family with a reference 1.5 times too large."""

from retrieval_bench.archs import bidir_decoder as base

build_encoder = base.build_encoder
encode_flops = base.encode_flops


def sparse_reps(*a, **kw):
    return 1.5 * base.sparse_reps(*a, **kw)
'''

MODEL_READER = '''"""The toy's hidden size, from the run's model dict."""


def read(rec):
    return rec["model"]["hidden_size"]
'''

TEXT = "qwen2-1.5b.text-short"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench() -> dict:
    return run.load_json(run.ROOT, "BENCHMARK.json")


def _copy(tmp_path, files: dict) -> tuple[str, dict]:
    """A copy of the harness under ``tmp_path`` with ``files`` (relative
    to ``retrieval_bench/``) added; returns its root and the digest of
    what was there before."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "retrieval_bench"),
                    os.path.join(root, "retrieval_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(root)
    for rel, text in files.items():
        path = os.path.join(root, "retrieval_bench", rel)
        assert not os.path.exists(path), rel
        with open(path, "w") as f:
            f.write(text)
    return root, before


def test_every_configuration_names_an_arch_that_its_cells_can_use():
    bench = _bench()
    for entry in bench["configs"]:
        conf = run.load_json(run.ROOT, entry["file"])
        cells = [w for w in bench["workloads"]
                 if w["config"] == entry["name"]]
        assert cells, entry["name"]
        for wl in cells:
            _, _, traffic = run.cell_spec(bench, wl["name"])
            kind = importlib.import_module(
                f"retrieval_bench.kinds.{traffic['kind']}")
            arch = run.load_arch(run.ROOT, entry, conf, kind)
            for name in getattr(kind, "ARCH", ()):
                assert callable(getattr(arch, name)), (wl["name"], name)


# sha256 over (name, bf16 bits) of the tiny encoders' tensors in name
# order, as the parent tree's program.build_encoder made them
WEIGHTS_SHA = {
    "qwen2-1.5b":
        "754074da58d73e7d81f80eebc2a99456ac94ed79ad6b088921950ec1d7ce4641",
    "mistral-7b":
        "7d5fa4ccdf8a39248801a94af0a020644184f53b6774de02ff5a6bc1e1a0ff03",
}


@pytest.mark.parametrize("cell", sorted(WEIGHTS_SHA))
def test_the_decoder_encoder_holds_the_drawn_weights_bit_for_bit(cell):
    conf = tiny_conf(cell)
    m = conf["model"]
    enc = bidir_decoder.build_encoder(conf, SEED, "cpu")
    emb = gen.embed_weights(m, SEED, "cpu")
    want = {"embed_tokens.weight": emb["embed"],
            "final_norm": emb["final_norm"]}
    head = gen.head_weight(m, SEED, "cpu")
    if head is not None:
        want["lm_head.weight"] = head
    bias = {"bq": "wq.bias", "bk": "wk.bias", "bv": "wv.bias"}
    for i in range(m["num_hidden_layers"]):
        for name, t in gen.layer_weights(m, SEED, i, "cpu").items():
            key = bias.get(name) or (name if name.endswith("norm")
                                     else f"{name}.weight")
            want[f"layers.{i}.{key}"] = t
    got = enc.params.state_dict()
    assert set(got) == set(want)
    h = hashlib.sha256()
    for k in sorted(want):
        assert got[k].dtype == want[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k], want[k]), k
        h.update(k.encode())
        h.update(got[k].contiguous().view(torch.int16).numpy().tobytes())
    assert h.hexdigest() == WEIGHTS_SHA[cell]


# the parent tree's flops.py at the published widths: encode_flops for a
# text of n tokens, train_flops at the train cell's groups [(8, 64),
# (136, 128)] with full remat and without
ENCODE_FLOPS = {
    "qwen2-1.5b": {1: 3087310848.0, 12: 37070438400.0, 16: 49438261248.0,
                   56: 173419266048.0},
    "mistral-7b": {1: 14221312000.0, 12: 170724950016.0,
                   40: 569670369280.0, 64: 912277897216.0},
}
TRAIN_FLOPS = {
    "qwen2-1.5b": (158767358410752.0, 111420981116928.0),
    "mistral-7b": (763368159838208.0, 512043853545472.0),
}


@pytest.mark.parametrize("config", sorted(ENCODE_FLOPS))
def test_the_decoder_flops_are_unchanged(config):
    bench = _bench()
    entry = run.config_entry(bench, config)
    m = run.load_json(run.ROOT, entry["file"])["model"]
    tr = run.load_json(run.ROOT, "retrieval_bench", "traffic",
                       "train-nce.json")
    groups = [(tr["bz"], tr["q_len"]),
              (tr["bz"] * (1 + tr["n_negs"]), tr["d_len"])]
    assert groups == [(8, 64), (136, 128)]
    for n, want in ENCODE_FLOPS[config].items():
        assert bidir_decoder.encode_flops(m, n) == want, n
    assert (bidir_decoder.train_flops(m, groups, True),
            bidir_decoder.train_flops(m, groups, False)) == \
        TRAIN_FLOPS[config]


def test_a_non_llama_architecture_is_added_as_new_files(tmp_path):
    conf = {"model": {"vocab_size": 512, "hidden_size": 48},
            "arch": "toy_bag", "index": tiny_conf(TEXT)["index"]}
    mix = tiny_traffic(_bench(), TEXT)
    mix.update(rate_qps=60, sample=6)
    lim = run.load_json(run.ROOT, "retrieval_bench", "limits",
                        f"{TEXT}.json")
    root, before = _copy(tmp_path, {
        "archs/toy_bag.py": TOY_ARCH,
        "configs/toy-bag.json": json.dumps(conf),
        "traffic/toy-text.json": json.dumps(mix),
        "limits/toy-bag.toy-text.json": json.dumps(lim),
        "metrics/toy.hidden.py": MODEL_READER})
    bench = _bench()
    cell = "toy-bag.toy-text"
    bench["configs"].append({"name": "toy-bag", "source": "test",
                             "file": "retrieval_bench/configs/toy-bag.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "toy-bag",
                               "traffic": "toy-text", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("text_p50_ms", "mfu.text"):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "toy.hidden", "unit": "units",
                               "better": "higher", "source": "program_counter",
                               "layer": "encoder", "moves": "text_p50_ms",
                               "workloads": [cell]})

    res = run.run_cell(bench, cell, SEED, 0.3, True, torch.device("cpu"),
                       root=root)
    assert res["correct"], res["compared"]
    assert set(res["compared"]) == set(lim["limits"])
    assert res["metrics"]["toy.hidden"]["value"] == 48
    toy = run.load_file(os.path.join(root, "retrieval_bench", "archs",
                                     "toy_bag.py"), "toy_bag")
    rec = res["out"]["record"]
    words = gen.fixed_counts(mix["words"], res["out"]["attempted"])
    assert rec["flops"] == sum(toy.encode_flops(conf["model"], int(n))
                               for n in words)
    assert rec["flops"] != sum(bidir_decoder.encode_flops(
        dict(tiny_conf(TEXT)["model"], **conf["model"]), int(n))
        for n in words)
    mfu = 100.0 * rec["flops"] / rec["window_s"] / flops.BF16_OPS_PER_S
    assert res["metrics"]["mfu.text"]["value"] == pytest.approx(mfu,
                                                                rel=1e-12)
    after = digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_the_run_is_judged_against_the_configuration_s_reference(tmp_path):
    root, _ = _copy(tmp_path, {"archs/scaled.py": SCALED_ARCH})
    bench = _bench()
    res = run.run_cell(bench, TEXT, SEED, 0.3, False, torch.device("cpu"),
                       root=root, conf=dict(tiny_conf(TEXT), arch="scaled"),
                       traffic=tiny_traffic(bench, TEXT),
                       limits=check.limits(run.ROOT, TEXT))
    assert not res["correct"], res["compared"]
    c = res["compared"]["rep_weight_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("case", ["unknown", "no key", "no training"])
def test_a_bad_arch_ends_the_run_naming_the_path(case, tmp_path):
    root, _ = _copy(tmp_path, {"archs/toy_bag.py": TOY_ARCH})
    bench = _bench()
    cell = "qwen2-1.5b.train-nce" if case == "no training" else TEXT
    conf = tiny_conf(cell)
    if case == "unknown":
        conf["arch"], want = "nope", "retrieval_bench/archs/nope.py"
    elif case == "no key":
        del conf["arch"]
        want = "retrieval_bench/configs/qwen2-1.5b.json"
    else:
        conf["arch"] = "toy_bag"
        want = ("retrieval_bench/archs/toy_bag.py.*defines no train_flops, "
                "lora_factors, train_steps, which the train kind needs")
    with pytest.raises(SystemExit, match=want):
        run.run_cell(bench, cell, SEED, 0.3, False, torch.device("cpu"),
                     root=root, conf=conf, traffic=tiny_traffic(bench, cell))
