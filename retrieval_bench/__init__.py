"""The benchmark of the PyTorch and CUDA port (``scaling_retriever_tpu_torch``):
see ``run.py``."""
