"""The flash-attention kernels' share of their roofline in the profiled
serving sub-window: each launch's bound (``flops.flash_cost``: the
larger of its bytes over the memory rate and its products over the
rate for its inputs' type), summed, against the device time of the
flash kernels, in percent."""

from perfbench import bench


def read(rec):
    if rec["kind"] != "serve" or not rec["flash_bound_s"]:
        return None
    seconds = bench.kernel_seconds(rec["profile"], "flash_attention_kernel")
    if not seconds:
        return None
    return 100.0 * rec["flash_bound_s"] / seconds
