# Optimizer substrate: AdamW with global-norm clipping and master weights,
# the cosine schedule.
from .adamw import AdamW, OptState  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
