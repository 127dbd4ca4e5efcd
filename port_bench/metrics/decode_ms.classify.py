"""Host ms a batch spent reading and decompressing its samples' npz files
(the port's span ``nimagenet/decode`` in ``data/nimagenet.py``)."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "nimagenet/decode", "steps")
