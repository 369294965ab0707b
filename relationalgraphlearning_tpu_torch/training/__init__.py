"""Training-side modules: the explorer's evaluation rollouts."""
