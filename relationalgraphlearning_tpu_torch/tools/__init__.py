"""Tools of the port: the kernel A/B harness (``tools/ab_kernel.py``), the
quality table's regeneration (``tools/reproduce_quality.py``) and the
unicycle failure breakdown (``tools/diag_unicycle.py``)."""
