"""Policies: the action space, epsilon-greedy and the MP-RGL planner."""
