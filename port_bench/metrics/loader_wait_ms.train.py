"""Host ms a step spent in next() of the batch feed (the loader thread
and device_prefetch; benchmark span ``loader``)."""
from port_bench.readers import per_call_ms


def read(run):
    return per_call_ms(run, "loader_wait_s", "steps")
