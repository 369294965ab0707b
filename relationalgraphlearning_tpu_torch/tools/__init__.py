"""Tools of the port: the kernel A/B harness (``tools/ab_kernel.py``)."""
