"""Applications of the port (kernel-backed workloads)."""
