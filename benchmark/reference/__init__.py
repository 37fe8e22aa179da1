"""The plain reference of the benchmark's cells: PyTorch and NumPy only.

It imports neither the JAX package nor anything of the port, and takes
nothing the program made: the benchmark hands it the same inputs (weights,
fill rows, batches, requests) that it hands the program, made from the seed.
"""
