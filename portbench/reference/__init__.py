"""Plain PyTorch references of what the benchmark's cells compute.

They import nothing of the program (``avsl_tpu_torch``) and nothing of the
JAX package, and take nothing that the program made: the harness hands
them the same seed-made weights and inputs that it gave the program.
"""
