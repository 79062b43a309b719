"""Benchmark drivers of the port, one module per root ``bench*.py`` of the
JAX package: ``python3 -m scaling_retriever_tpu_torch.benches.<name>``.

Each driver generates its corpus on the device from ``--seed``, runs on
``cuda`` unless ``--device cpu`` is given (asked for ``cuda`` without a
card it raises), writes its detail to stderr, and prints one JSON line
last on stdout: ``metric``, ``value``, ``unit``, the card's name and power
limit (``card``), ``correct``, and the same-run arms by name. A mismatch in
the driver's correctness check exits non-zero.
"""
