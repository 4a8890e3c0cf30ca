"""Counterparts of the JAX package's kernel tools (the fused Inception
block A/B and the dynamic-roll reproduction). Imports nothing eagerly."""
