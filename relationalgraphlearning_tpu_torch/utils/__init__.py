"""Host-side utilities: episode rendering, training curves, profiling."""
