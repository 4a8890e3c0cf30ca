"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy. It imports neither ``jax`` nor the JAX package nor
anything of ``videoquery_torch``, and takes nothing that the program made:
it is handed the inputs and weights the benchmark made, and works out again
what the program derives from them. Frozen copies of the program's plain
versions (the optimizer's grid, BN-Inception's forward, the TV-L1 chain)
say where they were copied from.
"""
