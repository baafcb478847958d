"""Plain float32 reference of the GRIT models, for the comparison that
decides a run's ``correct``.  It imports torch alone: nothing of the program
under test and nothing of the JAX package."""
