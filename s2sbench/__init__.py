"""The benchmark of the port (``s2s_tpu_torch``): see ``s2sbench/README.md``."""
