"""The micro config's keys (test_torch_slam_keys.py CASES) on an anisotropic
map (gaussian_distribution="anisotropic", log_scales [N, 3]) at
rebin_every=8: tracking in pair space from world-16 rows, mapping on the
generic render with reused structures (test_torch_slam_aniso.py's route).
Every key applies there: the loss masks and weights, the tracking schedule,
pruning (remove-big reads the largest of the three scales) and the opacity
reset. Same checks and tolerances as test_config_key_matches_jax."""
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from test_torch_slam_keys import CASES, bases, check_key  # noqa: F401  (bases: a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(k for k in CASES if not k.endswith("_rebin1")))
def test_config_key_anisotropic_matches_jax(tmp_path, bases, case):  # noqa: F811
    check_key(tmp_path, bases, case, {"gaussian_distribution": "anisotropic"})
