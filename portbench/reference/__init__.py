"""Plain references: straightforward PyTorch of the published algorithms,
in float64 (or, for the lower-precision control, float32 with TF32
products).  Nothing here imports the program, jax or the JAX package, and
nothing takes a value the program made: the benchmark hands both sides
the same inputs, and the references work out again everything the program
derives from them."""
