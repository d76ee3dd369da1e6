"""The frozen plain reference of the benchmark's configurations: plain PyTorch
and NumPy, importing nothing of the program and nothing of JAX."""
