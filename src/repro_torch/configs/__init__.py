"""Vision model configs (copy of the JAX package's configs/dacapo_pairs.py)."""
