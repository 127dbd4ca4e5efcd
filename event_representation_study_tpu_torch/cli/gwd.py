"""GWD (C_p) ranking of a representation, without training (port of the JAX
package's ``cli/gwd.py``; the reference is
representations/representation_search/gen1_compute.py).

Loops over the fixed chosen validation indices, builds the representation
and scores it against the raw events with the quadrant OTMI protocol, and
prints the mean C_p:

    python -m event_representation_study_tpu_torch.cli.gwd --data-path DIR \\
        --representation VoxelGrid [--batched] [--device cpu]

``--batched`` builds every sample's representation in one batched call
(K1/K2 on the card) and scores the batch with ``otmi_batched``.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(args=None):
    p = argparse.ArgumentParser("GWD representation ranking (PyTorch port)")
    p.add_argument("--data-path", type=str, required=True)
    p.add_argument("--event_representation_name", "--representation",
                   dest="representation", type=str, default="OptimizedRepresentation")
    p.add_argument("--num-events", type=int, default=50000)
    p.add_argument("--img-size", type=int, default=240,
                   help="representation side used by the quadrant crops")
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of samples (full chosen set otherwise)")
    p.add_argument("--batched", action="store_true",
                   help="build all representations in one batched call and score "
                        "them with metrics.otmi.otmi_batched")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(args)

    import torch

    from .. import resolve_device
    from ..data.gen1 import Gen1H5
    from ..metrics.chosen_indexes import extract_indexes
    from ..metrics.otmi import otmi
    from ..reps.dispatch import get_item_transform

    device = resolve_device(args.device)
    ds = Gen1H5(args.data_path, task="val", num_events=args.num_events)
    indices = extract_indexes(args.representation)
    if args.limit:
        indices = indices[: args.limit]

    if args.batched:
        from ..events import from_structured, stack_blocks
        from ..metrics.otmi import otmi_batched
        from ..reps.dispatch import batched_representation

        evs = [ds.structured_events(i) for i in indices]
        blocks = stack_blocks([from_structured(e, args.num_events) for e in evs]).to(device)
        reps = batched_representation(args.representation, ds.height, ds.width)(blocks)
        N = args.num_events
        arr = np.zeros((len(evs), N, 4), np.float32)
        mask = np.zeros((len(evs), N), np.float32)
        for j, e in enumerate(evs):
            n = min(len(e), N)
            arr[j, :n] = np.stack([e["x"][:n], e["y"][:n], e["t"][:n], e["p"][:n]], -1)
            mask[j, :n] = 1.0
        costs = otmi_batched(
            torch.from_numpy(arr).to(device), torch.from_numpy(mask).to(device),
            reps.to(torch.float32), ds.height, ds.width, rep_size=args.img_size,
        ).cpu().numpy()
    else:
        costs = []
        for idx in indices:
            ev = ds.structured_events(idx)
            rep = get_item_transform(ev, args.representation, None, ds.height, ds.width,
                                     args.num_events, device=device)
            events = np.stack([ev["x"], ev["y"], ev["t"], ev["p"]], -1).astype(np.float64)
            costs.append(otmi(events, rep, ds.height, ds.width, rep_size=args.img_size,
                              device=device))
    for idx, c in zip(indices, costs):
        print(f"idx {idx}: C_p = {c:.5f}")
    print(f"mean C_p over {len(costs)} samples: {np.nanmean(costs):.5f}")
    return float(np.nanmean(costs))


if __name__ == "__main__":
    main()
