"""Host-side utilities: CLI flags, logging and TensorBoard scalars, profiling and step timing, checkpoints."""
