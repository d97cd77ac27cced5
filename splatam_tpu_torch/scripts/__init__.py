"""Measurement scripts of the port (python -m splatam_tpu_torch.scripts.<name>).

Counterparts of the JAX package's scripts of the same names under scripts/:
probe_unroll (fwd2 against the fused forward), probe_dma (the fused
forward's time split into its memory walk and its math) and profile_iter
(one tracking and one mapping iteration, stage by stage). They run on the
card unless `--device cpu` is given, and never fall back to the CPU.
"""
