"""Timed loop of the Swin detector's training: ``trainer_loop.py``'s, with
one addition in the traced window only: the port's window attention
(``models/swin_vit.py::WindowAttentionV2.forward``) runs in the span
``attn``, and the shapes of each call are kept (``attention.py``) for
``attn_roofline.swin``. The backward pass runs on autograd's thread and
stays in the span ``backward``.
"""
from __future__ import annotations

from port_bench import attention, core, tracing
from port_bench.drivers import trainer_loop

controls = trainer_loop.controls


def run(ctx: core.Context) -> core.Run:
    from event_representation_study_tpu_torch.models import swin_vit

    calls = []
    probe = trainer_loop._train_probe

    def attn_probe(counters):
        undo = probe(counters)
        undo_attn = tracing.wrap_attr(
            swin_vit.WindowAttentionV2, "forward", "attn",
            before=lambda module, x, ws, mask=None: calls.append(
                attention.call_of(module, x, ws, mask)))

        def restore():
            undo_attn()
            undo()

        return restore

    trainer_loop._train_probe = attn_probe
    try:
        run = trainer_loop.run(ctx)
    finally:
        trainer_loop._train_probe = probe
    if ctx.trace:
        run.extra["attn_least_s"] = attention.least_seconds(calls, run.extra["peak_flops"])
        run.extra["info"]["attn_calls"] = len(calls)
    return run
