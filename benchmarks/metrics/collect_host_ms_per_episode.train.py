"""Host milliseconds of collection an episode, as the port counts it: its
spans ``explorer.collect``, ``explorer.update_memory`` and
``explorer.count_episodes`` over the episodes finished (beside
``collect_ms_per_episode.train``, the driver's clock around the same calls
and its own records)."""

from benchmarks.metrics._read import host_ms_per

SPANS = ["explorer.collect", "explorer.update_memory",
         "explorer.count_episodes"]


def read(obs):
    return host_ms_per(obs, SPANS, obs.counters.get("episodes"))
