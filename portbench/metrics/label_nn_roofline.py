"""label_nn_roofline: kernel K3's share of its roofline in the traced
window, in %: the least time of its launches (portbench/counters.py:
each launch's compatible pairs x 12 operations at 67 TFLOP/s, or both
point clouds read once at 3.35 TB/s, the larger) over the device time
of its search kernel (label_nn_sorted_kernel) in the profiler's trace.
The plan kernels are left out of the time: the work the inputs need is
the search."""

KERNEL = "label_nn_sorted_kernel"


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("k3_bound_s"):
        return None
    device = sum(t for name, t in tr["device_ops_by_name"].items()
                 if KERNEL in name)
    if device <= 0:
        return None
    return 100.0 * rec["k3_bound_s"] / device
