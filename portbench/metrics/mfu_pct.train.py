"""mfu_pct.train: the model FLOPs of the window's training steps (3 x
the forward's convolutions and decoder layers, portbench/counters.py)
over the window's time, against the H100's float32 peak (67 TFLOP/s;
the configuration keeps TF32 off, so every convolution and matmul runs
in float32), in %."""

from portbench.counters import FP32_OPS


def read(rec):
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * FP32_OPS)
