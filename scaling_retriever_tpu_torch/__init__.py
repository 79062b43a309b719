"""PyTorch/CUDA port of scaling_retriever_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``scaling_retriever_tpu`` is the reference; this package
mirrors its layout (ops/ index/ models/ serving/ data/ evaluation/
utils/) and imports
neither JAX nor it. Hand-written CUDA kernels live in ``csrc/`` and are
built at first use (``ops/cuda_lib.py``).
"""
