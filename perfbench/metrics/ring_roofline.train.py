"""The ring kernels' share of their bytes bound in the profiled training
step: the bytes of every ring launch (its stacked input read once, its
output written once) over the memory rate, against the device time of
the ring kernels, in percent."""

from perfbench import bench, flops


def read(rec):
    if rec["kind"] != "train" or not rec["ring_bytes"]:
        return None
    seconds = bench.kernel_seconds(rec["profile"], "ring_kernel",
                                   "ring_cluster_kernel")
    if not seconds:
        return None
    return flops.roofline_share(0, 1, rec["ring_bytes"], seconds)
