"""Host ms a request from the call of ops/nms.py::non_max_suppression until
its outputs are ready (span ``nms``, closed on a synchronise in the traced
run)."""
from port_bench.readers import per_call_ms


def read(run):
    return per_call_ms(run, "nms_s", "requests")
