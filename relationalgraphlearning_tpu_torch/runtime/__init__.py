"""Native components: the C++ ORCA solver bound by ctypes."""
