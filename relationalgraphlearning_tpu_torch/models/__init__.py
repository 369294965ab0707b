"""Models: MLP and the SparseRGL value net."""
