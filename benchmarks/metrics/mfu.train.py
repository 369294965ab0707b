"""The whole step's model FLOPs over the window against the card's float32
peak (%); counted from shapes by ``benchmarks/counters/flops.py``."""

from benchmarks.metrics._read import mfu as read  # noqa: F401
