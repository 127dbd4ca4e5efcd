"""Device ms a training step inside the window attention's forward calls
(the span ``attn``; the backward pass is in ``backward``). None where the
trace holds no device time there (no card, or a cell without the span)."""


def read(run):
    if run.trace is None or "attn_least_s" not in run.extra or not run.extra.get("steps"):
        return None
    device_s = run.trace.device_s("attn")
    return 1e3 * device_s / run.extra["steps"] if device_s > 0 else None
