"""Millions of Gaussians a mapping phase steps: the rows of the map's span
that slam/steps.py mapping_phase handed to Adam
(mapping_phase.totals["gaussians"], the port's counter), over the phases
run (totals["phases"]). Read when the reader runs, so over every phase of
the run: the set-up frames, the window, the traced frames and the check
frame. The mapping phase's per-Gaussian state (its leaves, Adam's
moments, the gradients) scales with it. None where the program keeps no
such counter, or where no phase ran."""
import sys


def read(trace):
    steps = sys.modules.get("splatam_tpu_torch.slam.steps")
    totals = getattr(getattr(steps, "mapping_phase", None), "totals", None)
    if not totals or not totals.get("phases"):
        return None
    return totals["gaussians"] / totals["phases"] / 1e6
