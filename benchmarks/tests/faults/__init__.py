"""The faults a cell's timed path can have, planted in the program on the
CPU: one module a driver, ``faults/<driver>.py``, whose ``FAULTS`` maps each
fault's name ("state unchanged", "half the batch", "answer altered") to a
function that plants it with pytest's ``monkeypatch``."""
