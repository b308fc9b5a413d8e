"""The LM drivers and what they run on (the JAX package's ``launch/``):
``mesh.py`` (the host mesh over the process group, the abstract
production meshes), ``sharding.py`` (the logical-axis rules per arch,
shape kind and mesh), ``steps.py`` (the train, prefill and decode
``StepBundle``s), ``serve.py`` (prefill + batched greedy decode) and
``train.py`` (the training loop with checkpoints, heartbeats and straggler
detection). The dry run (``lower_bundle``, the HLO analysis and reports)
is ROADMAP item 10d."""
