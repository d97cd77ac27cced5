"""Entry points and measurement scripts of the port
(python -m splatam_tpu_torch.scripts.<name>).

Counterparts of the JAX package's scripts of the same names under scripts/:
splatam (the online SLAM run: rgbd_slam, checkpoints, eval, params.npz),
eval_novel_view (eval of a saved params.npz), export_ply (params.npz to a
.ply splat, host only); probe_unroll (fwd2 against the fused forward),
probe_dma (the fused forward's time split into its memory walk and its
math), profile_iter (one tracking and one mapping iteration, stage by
stage), profile_map_ablate (a mapping iteration with one part off at a
time), probe_saturation (the pairs a per-tile trim would keep), exp_gather
(row gathers; tracking's per-rebin gather), profile_sharded (row bands:
pairs per band and their time) and dryrun_multichip (__graft_entry__.py's
banded 2-frame loop). Of the port alone: bands_multicard (row bands spread
over several cards against the same bands on one card). Those that use a
device run on the card unless `--device cpu` is given, and never fall back
to the CPU.
"""
