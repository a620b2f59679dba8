"""Weight carriers between the JAX package's checkpoints and the port."""
