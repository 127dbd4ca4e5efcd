"""Event-file conversion CLI — the equivalent of ev-licious's conversion
scripts (ev-licious/scripts/conversion/*, scripts/processing/
write_events_to_rosbag.py): read any supported event format
(.h5/.npz/.npy/.dat/.bin/.bag) and write the canonical HDF5 layout
(events/{x,y,t,p,height,width,divider}) — or a ROS1 bag of
dvs_msgs/EventArray messages when --output ends in .bag. A copy of the JAX
package's ``cli/convert.py``; ``.h5`` goes through ``events/h5_io.py``'s
``H5Writer`` (h5py, or without it ``events/h5lite.py``).

    python -m event_representation_study_tpu_torch.cli.convert \
        recording.dat --output recording.h5 --height 240 --width 304
"""
from __future__ import annotations

import argparse
import pathlib


def main(args=None):
    ap = argparse.ArgumentParser("event format conversion")
    ap.add_argument("input", help=".h5/.npz/.npy/.dat/.bin/.bag event file")
    ap.add_argument("--output", required=True, help="output .h5 or .bag path")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=1_000_000,
                    help="events per incremental write")
    ap.add_argument("--filter", action="append", default=[],
                    choices=["hot_pixel", "background_activity", "refractory",
                             "random", "contrast_threshold"],
                    help="apply stream filters in order (the five ev-licious "
                         "filter types, tools/filters.py:23-110; "
                         "events/filters.py)")
    ap.add_argument("--filter-depth-us", type=int, default=10000)
    ap.add_argument("--filter-downsample", type=int, default=2,
                    help="random filter: keep 1/N of events")
    ap.add_argument("--filter-contrast-mult", type=int, default=2,
                    help="contrast-threshold filter: event-count multiplier")
    args = ap.parse_args(args)
    out_suffix = pathlib.Path(args.output).suffix
    if out_suffix not in (".h5", ".hdf5", ".npz", ".bag"):
        # fail BEFORE loading/filtering a potentially multi-GB input
        ap.error(f"unsupported output format {out_suffix!r} "
                 "(.h5/.hdf5/.npz/.bag)")

    import numpy as np

    from ..events.h5_io import H5Writer, load_events_from_path

    ev = load_events_from_path(args.input)
    height = args.height
    width = args.width
    if pathlib.Path(args.input).suffix == ".dat" and (height is None or width is None):
        from ..events.prophesee import EventDatReader

        with EventDatReader(args.input) as r:
            height = height or r.height
            width = width or r.width
    height = height or (int(ev["y"].max()) + 1 if len(ev) else 1)
    width = width or (int(ev["x"].max()) + 1 if len(ev) else 1)

    for name in args.filter:
        from ..events import filters as F

        if name == "hot_pixel":
            ev = F.hot_pixel_filter(ev, height, width)
        elif name == "background_activity":
            ev = F.background_activity_filter(ev, height, width,
                                              depth_us=args.filter_depth_us)
        elif name == "random":
            ev = F.random_filter(ev, args.filter_downsample)
        elif name == "contrast_threshold":
            ev = F.contrast_threshold_filter(ev, height, width,
                                             args.filter_contrast_mult)
        else:
            ev = F.refractory_period_filter(ev, height, width,
                                            depth_us=args.filter_depth_us)

    if out_suffix == ".bag":
        from ..events.rosbag import write_events_to_rosbag

        write_events_to_rosbag(args.output, ev, height=height, width=width)
    elif out_suffix == ".npz":
        # N-ImageNet-style structured payload; readable by
        # load_events_from_path (suffix dispatch, no pickling)
        np.savez_compressed(args.output, event_data=ev)
    elif out_suffix in (".h5", ".hdf5"):
        with H5Writer(args.output, height=height, width=width) as w:
            for i in range(0, max(len(ev), 1), args.chunk):
                chunk = ev[i : i + args.chunk]
                if len(chunk):
                    w.add(chunk["x"], chunk["y"], chunk["t"], chunk["p"])
    print(f"wrote {len(ev)} events -> {args.output} ({height}x{width})")
    return args.output


if __name__ == "__main__":
    main()
