"""Milliseconds of one SGD step: the host clock around each iteration's
``optimize_batches`` sweeps, to the loop's own sync on the loss, over the
steps they ran."""


def read(obs):
    steps = obs.counters.get("sgd_steps")
    if not steps or "sgd" not in obs.spans:
        return None
    return 1000.0 * sum(obs.spans["sgd"]) / steps
