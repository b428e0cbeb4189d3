"""The plain reference: the same queries on the same data in NumPy.

It builds its own adjacency from the generator's raw arrays and answers
every query with a function of its own whose join order is written down
in it.  It imports nothing of the system under test: no ``repro_torch``,
no ``repro``, no ``jax``.
"""
