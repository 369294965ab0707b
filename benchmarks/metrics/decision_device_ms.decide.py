"""Device milliseconds of one decision: CUDA events around each graph
replay, averaged over the window's decisions (set against the host's
latency, ``decision_ms_p95``)."""


def read(obs):
    ms = obs.samples.get("decision_device_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
