"""Mini N-ImageNet samples trained in the window over its seconds (whole
epochs; every step reads its logits back; host clock)."""
from port_bench.readers import per_second


def read(run):
    return per_second(run, "samples")
