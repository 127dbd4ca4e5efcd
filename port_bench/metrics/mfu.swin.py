"""Model FLOPs of the Swin detector's train steps (forward x 3, counted on
the reference's frozen detector) over the traced window and the peak of
the precision used."""
from port_bench.readers import mfu_pct


def read(run):
    return mfu_pct(run, "flops_per_step", "steps")
