"""The plain reference the benchmark holds the program against.

``frozen/`` holds copies of the port's plain modules (each names the file
and commit it was copied from in its first docstring line), with the
kernels replaced by their plain versions and the physics step run op by
op; ``generation.py`` and ``training.py`` drive them over the benchmark's
inputs; ``compare.py`` turns the two sides into the numbers that decide
``correct``; ``precision.py`` is the control.  Nothing here imports the
program, the JAX package or JAX.
"""
