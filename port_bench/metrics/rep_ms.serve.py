"""Device ms a request of the kernels launched inside the representation
call (reps/dispatch.py::batched_representation; span ``representation``)."""
from port_bench.readers import per_call_ms


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None  # no device operation traced
    return per_call_ms(run, "rep_s", "requests")
