"""The data plane: drifting frame streams and the speculative pipeline
(numpy-only copies of the JAX package's data/stream.py and data/pipeline.py)."""
