"""Host milliseconds of the scenario draw a call: the port's span
``explorer.reset`` (the cases' starting states drawn on the host and
uploaded, serial with the device) over the window's calls."""

from benchmarks.metrics._read import host_ms_per


def read(obs):
    return host_ms_per(obs, ["explorer.reset"], obs.calls)
