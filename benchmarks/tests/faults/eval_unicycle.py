"""The unicycle evaluation's faults: the robot never moves, half of the
envs' humans left standing, the decisions altered."""

from benchmarks.tests.faults.eval import FAULTS  # noqa: F401
