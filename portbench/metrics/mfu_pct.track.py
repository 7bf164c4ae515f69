"""mfu_pct.track: the model FLOPs of the window's `track` calls over
their time, against the H100's float32 peak (67 TFLOP/s; the
configuration keeps TF32 off), in %. Model FLOPs (portbench/counters.py):
SIF-Net's encode per frame encoded, and every decoder head at every
point queried at the net's boundary (twice where the query is
differentiated w.r.t. its points). The kernels' operations are not
counted."""

from portbench.counters import FP32_OPS


def read(rec):
    if not rec.get("flops") or not rec.get("call_seconds"):
        return None
    return 100.0 * rec["flops"] / (rec["call_seconds"] * FP32_OPS)
