"""Frame stages of the fast path (counterparts of the JAX package's ops)."""
