"""How the benchmark hands its inputs to the system under test, the port
``scaling_retriever_tpu_torch``, where no architecture is involved: the
port's model configuration from a published config, and the engine over
the benchmark's index arrays (an architecture's encoder is built by its
module in ``archs/``). The port is imported here, in ``archs/`` and in
the kinds, never at the top of a module the reference or the tests'
import walk reads first.
"""

from __future__ import annotations

import torch

from retrieval_bench import gen


def model_config(m: dict, **overrides):
    from scaling_retriever_tpu_torch.models.config import ModelConfig

    kw = {"dtype": torch.bfloat16, "param_dtype": torch.bfloat16,
          **overrides}
    return ModelConfig.from_hf_config(m, **kw)


def build_engine(conf: dict, topk: int, t_budget: int, device):
    """A ``SegsortEngine`` over the configuration's uniform index in the
    f32 layout, made on the device."""
    from scaling_retriever_tpu_torch.ops.segsort_scoring import SegsortEngine

    ix = conf["index"]
    rows, bits, offsets, _ = gen.index_rows(ix, conf["model"]["vocab_size"],
                                           device)
    return SegsortEngine(topk=topk, query_terms_budget=t_budget,
                         device_csr=(rows, bits, offsets, ix["n_docs"]))
