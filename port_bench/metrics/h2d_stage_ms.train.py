"""Host ms a step spent pinning each batch's leaves and starting their
copies to the card (the port's span ``h2d/stage`` in
``parallel/mesh.py::device_prefetch``)."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "h2d/stage", "steps")
