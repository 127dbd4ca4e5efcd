from .core import (
    EventBlock,
    from_structured,
    normalize_polarity,
    pad_events,
    stack_blocks,
)
from .fake import generate_fake_events
