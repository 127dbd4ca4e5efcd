"""Host ms a step that the step's thread waited on an empty loader queue
(the port's span ``loader/wait`` in ``data/loader.py::prefetched``)."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "loader/wait", "steps")
