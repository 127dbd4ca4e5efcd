"""Export of the serving graph (the JAX package's ``utils/export.py``; the
reference's TensorRT/ONNX deployment, ev-YOLOv6/yolov6/models/end2end.py):
the serving pipeline of ``cli/infer.py::Server`` (events -> representation
-> letterbox -> detector -> NMS), written by ``torch.export`` so that it
runs later without the Python model code.

The graph takes the five tensors of an ``EventBlock`` (x, y, t, p, num) and
returns ``(dets (B, 300, 6), counts (B,))``. Kernel K1 is the operator
``torch.ops.ers.segment_reduce_sorted`` in it (``ops/fused_scatter.py``), so
loading a graph needs this package imported, which :func:`load_serving_graph`
does. NMS has static shapes, so its 300 steps are unrolled into the graph.
"""
from __future__ import annotations

import pathlib

import torch
from torch import nn

from ..events.core import EventBlock
from ..ops import fused_scatter  # noqa: F401  (registers the K1/K2 operator)


class ServingGraph(nn.Module):
    """A ``cli/infer.py::Server``'s serving function as a module whose
    ``forward`` takes an EventBlock's five tensors; the server's model
    (in eval mode) is its submodule, so its weights go into the graph."""

    def __init__(self, server):
        super().__init__()
        self.model = server.model.eval()
        self.server = server

    def forward(self, x, y, t, p, num):
        return self.server.pipeline(EventBlock(x, y, t, p, num))[2:]


def build_serving_fn(server) -> ServingGraph:
    """The serving function (events in, detections out) of ``server``
    (``cli/infer.py::make_server``), on its weights and device."""
    return ServingGraph(server)


def export_serving_graph(serve_fn: nn.Module, example_blocks: EventBlock, path):
    """Trace ``serve_fn`` on ``example_blocks`` (int32, on the model's
    device; the graph keeps their shapes) with ``torch.export`` and write
    the program to ``path``; returns the ``ExportedProgram``."""
    blocks = example_blocks.as_int32()
    program = torch.export.export(serve_fn, (blocks.x, blocks.y, blocks.t, blocks.p, blocks.num))
    torch.export.save(program, str(pathlib.Path(path)))
    return program


def load_serving_graph(path):
    """The exported serving graph at ``path`` as a callable
    ``(x, y, t, p, num) -> (dets, counts)``."""
    return torch.export.load(str(pathlib.Path(path))).module()
