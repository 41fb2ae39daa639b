"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch and NumPy, float32 with TF32 off (float64 where a distance
is judged). Nothing here imports JAX, the JAX package or the port: the
reference takes the rows the benchmark drew from the seed, and reads the
port's answers and index arrays only to judge them."""
