"""Environments: batched ORCA and the mega-crowd rollout."""
