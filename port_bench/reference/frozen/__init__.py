"""Frozen copies of the port's plain modules, for the plain references.

Each file is the port's (``event_representation_study_tpu_torch/``, same
relative path) as the benchmark was written, cut to what the references
run: ``ops/fused_scatter.py`` keeps only the sort glue and the plain
segment reduction (no CUDA kernel), ``ops/warp.py`` loses the K3 executor,
``models/yolo.py`` the learned representation and the Swin ViT,
``train/losses.py`` the process group, ``data/nimagenet.py`` the host
loader types and the fixture writer, and the detector's forward skips
``torch.autocast`` in float32 so that FLOPs can be counted on ``meta``.
Nothing here imports the port; a later change to the port does not move
the references.
"""
