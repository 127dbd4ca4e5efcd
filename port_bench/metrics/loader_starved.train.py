"""Share of the step thread's takes from the loader queue that found it
empty (the port's counters ``loader/empty_takes`` over ``loader/takes``)."""
from port_bench.program import counter_pct


def read(run):
    return counter_pct(run, "loader/empty_takes", "loader/takes")
