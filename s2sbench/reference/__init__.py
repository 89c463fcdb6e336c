"""The plain reference that decides ``correct``: plain PyTorch in f32, importing
nothing of the program and nothing of JAX."""
