"""The LM drivers (the single-card half of the JAX package's ``launch/``):
``serve.py`` (prefill + batched greedy decode) and ``train.py`` (the
training loop with checkpoints, heartbeats and straggler detection).
Meshes, sharding rules, ``steps.py``'s bundles and the dry run are
ROADMAP item 10c."""
