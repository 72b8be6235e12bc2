"""The benchmark's plain reference: NumPy only, independent of the port.

Nothing here imports the port, the JAX package or JAX. The reference
works out again, from the inputs the benchmark made, what the port must
produce: the boundary's fixed-point rows (``boundary``), F's bookkeeping
and the HNSW graph and answers (``hnsw``). ``check`` compares the port's
outputs against it.
"""
