"""The paper's figure experiments (the JAX package's ``benchmarks/``
figure scripts): Table III's model counts, Fig. 3's FLOP breakdown, and
Figs. 9, 11 and 12, which compare DaCapo with the Ekya and EOMU baselines
on drifting streams. ``python -m repro_torch.experiments [--fast] [--only
fig9,...] [--device cpu]`` prints their ``name,us_per_call,derived``
rows; each module's ``run`` returns them."""
