from .dispatch import (
    REPRESENTATION_CHANNELS,
    batched_representation,
    build_representation,
    get_item_transform,
)
from .ergo12 import ergo12, get_optimized_representation
from .event_stack import event_stack
from .fused_mdes import ergo12_fused_batched, mdes_fused_batched
from .histogram import event_histogram
from .mdes import mixed_density_event_stack
from .time_surface import time_surface
from .tore import tore
from .voxel_grid import voxel_grid
