"""K1 (segment_reduce_sorted) least time over the device time of its
kernels, in the traced classification window."""
from port_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1", "k1_bytes")
