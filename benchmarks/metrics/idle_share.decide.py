"""The device's idle share of the traced window (%), 1 − Σ busy / wall."""

from benchmarks.metrics._read import idle_share as read  # noqa: F401
