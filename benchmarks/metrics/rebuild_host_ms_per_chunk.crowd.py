"""Host milliseconds of the graphs' rebuild a chunk: the port's span
``crowd.rebuild`` (the sort, the grid kNN, the windows and the masks,
between a chunk's replays) over the chunks the window rolled."""

from benchmarks.metrics._read import host_ms_per


def read(obs):
    return host_ms_per(obs, ["crowd.rebuild"], obs.counters.get("chunks"))
