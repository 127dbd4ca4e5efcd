"""The window attention's least time (``attention.py``: its matmul FLOPs
at the precision's peak, or its least bytes at the HBM rate, whichever is
longer, call by call) over the device time of the kernels its forward
calls launched (the span ``attn``), in the traced training window."""


def read(run):
    if run.trace is None or "attn_least_s" not in run.extra:
        return None
    device_s = run.trace.device_s("attn")
    return 100.0 * run.extra["attn_least_s"] / device_s if device_s > 0 else None
