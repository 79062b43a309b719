"""Arithmetic the per-layer metric readers share (each reader is a file
of ``metrics/`` named as its metric). A reader gets the run's record and
returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

from retrieval_bench import flops


def mfu(rec: dict):
    """The window's model FLOPs over the window, as % of the bf16 peak."""
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / flops.BF16_OPS_PER_S


def retrieval_roofline(rec: dict):
    """The least time the window's retrievals need (their bytes over the
    HBM bandwidth) as % of the device time of the work launched inside
    the engine's spans."""
    tr = rec.get("trace")
    if tr is None or not rec.get("retrieval_bytes"):
        return None
    device_s = tr.span_device_s(rec["retrieval_spans"])
    if device_s <= 0:
        return None
    return 100.0 * rec["retrieval_bytes"] / flops.HBM_BYTES_PER_S / device_s


def device_idle(rec: dict):
    """% of the traced window in which nothing ran on the device."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
