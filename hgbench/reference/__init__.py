"""Plain references the benchmark judges the program's outputs by.

Plain PyTorch and NumPy, written from the semantics the configurations
state (Cartographer's and HectorGrapher's cost functors, insertion rules
and solvers). Nothing here imports JAX, the JAX package or anything of
the program, and nothing reads a table, weight or derived array that the
program made: what the program derived from the generated inputs is
worked out here again.
"""
