"""Models: camera and splat cloud (counterparts of the JAX package's models)."""
