"""The benchmark's plain reference: NumPy, independent of the program.

Nothing here imports the program under test or JAX; the tables are worked
out again from the geometry, so no plan or table of the program is read.
"""
