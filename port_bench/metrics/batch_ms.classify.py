"""Host ms a batch the step thread spent assembling its batch: the port's
span ``nimagenet/batch`` in ``data/nimagenet.py`` (the decode and prep on
the dataset's thread pool, the draws between them). None where the window
never opened ``nimagenet/batch``."""
from port_bench.program import span_ms


def read(run):
    return span_ms(run, "nimagenet/batch", "steps") or None
