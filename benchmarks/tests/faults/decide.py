"""The decision driver's fault: the decision altered (one robot's state
in, one action out: no state to leave unchanged, no batch to halve)."""

from benchmarks.tests.faults._mprl import flip_decisions

FAULTS = {"answer altered": flip_decisions}
