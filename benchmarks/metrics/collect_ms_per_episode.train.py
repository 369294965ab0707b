"""Milliseconds of collection an episode: the host clock around
``collect``, ``update_memory`` and ``count_episodes``, to the loop's own
sync on the episode count, over the episodes finished."""


def read(obs):
    episodes = obs.counters.get("episodes")
    if not episodes or "collect" not in obs.spans:
        return None
    return 1000.0 * sum(obs.spans["collect"]) / episodes
