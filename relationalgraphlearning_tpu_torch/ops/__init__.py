"""Graph ops: kNN graphs, the fixed-K chain, block windows, fused kernel."""
