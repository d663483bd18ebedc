# Serving substrate: epoch-synchronized continuous batching — the TVM's
# task vector realized as request slots (DESIGN.md §3).
from .engine import EpochServer, Request  # noqa: F401
