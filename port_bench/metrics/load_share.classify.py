"""Share of the window spent assembling host batches: run_epoch's load_s
(npz decode, slice, reshape, augment, collate, copy to the card) over the
window."""


def read(run):
    if "load_s" not in run.extra or run.window_s <= 0 or run.trace is None:
        return None
    return 100.0 * run.extra["load_s"] / run.window_s
