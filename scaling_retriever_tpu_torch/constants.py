"""Dataset-source registry (port of constants.py): paths are matched by
substring, and unknown paths fall back to the ``data_source`` CLI flag."""

supported_models = ["t5", "llama", "bert", "qwen2", "mistral"]

corpus_datasource = {
    "msmarco": "msmarco",
    "wiki": "wiki",
    "nq": "wiki",
}


def guess_data_source(path: str, default: str = "msmarco") -> str:
    if path:
        low = path.lower()
        for key, source in corpus_datasource.items():
            if key in low:
                return source
    return default
