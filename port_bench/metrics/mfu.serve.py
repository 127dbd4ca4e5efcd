"""Forward FLOPs a request x requests over the traced window and the peak
of the precision used."""
from port_bench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_request", "requests")
