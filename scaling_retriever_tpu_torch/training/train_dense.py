"""Dense retriever training (port of training/train_dense.py): the
train_sparse CLI with the dense defaults, one "rank" task (no FLOPS
regularizer) and the temperature ``--T`` (default 0.01).

    python -m scaling_retriever_tpu_torch.training.train_dense ...
"""

from __future__ import annotations

from scaling_retriever_tpu_torch.training.train_sparse import main as _main


def main(argv=None, tokenizer=None):
    return _main(argv, pooling="dense", tokenizer=tokenizer)


if __name__ == "__main__":
    main()
