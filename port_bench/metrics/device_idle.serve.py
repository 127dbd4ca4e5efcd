"""Share of the traced serving window with no device operation."""
from port_bench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
