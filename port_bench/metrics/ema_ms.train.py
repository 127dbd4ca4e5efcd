"""Host ms an EMA blend takes, its state-dict walk included (the port's
span ``ema`` in ``train/ema.py``)."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "ema", "calls")
