from .dispatch import batched_representation
from .fused_mdes import ergo12_fused_batched, mdes_fused_batched
