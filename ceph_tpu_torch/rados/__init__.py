"""Object access: the embedded single-process cluster."""
