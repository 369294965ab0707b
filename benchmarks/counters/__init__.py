"""Operation and byte counts of the measured work, from the cells' shapes,
and the published peaks they are set against."""
