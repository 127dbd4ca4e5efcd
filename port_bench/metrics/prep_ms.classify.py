"""Host ms a batch spent preparing its samples' events: the float64
conversion, polarity, reshape, slice, augment, clip and int32 packing
(the port's span ``nimagenet/prep`` in ``data/nimagenet.py``)."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "nimagenet/prep", "steps")
