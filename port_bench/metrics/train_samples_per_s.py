"""Training windows whose step completed in the window over its seconds
(the window closes on a device synchronise; host clock)."""
from port_bench.readers import per_second


def read(run):
    return per_second(run, "samples")
