"""The micro config's keys (test_torch_slam_keys.py CASES) at
tpu.rebin_every=1: both phases take the generic render with no structure
(K1 -> K2 -> K3), as the configs' default runs them. Same checks and
tolerances as test_config_key_matches_jax; depth_loss_doubling_rebin1 is
that file's own case at rebin 1 already."""
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from test_torch_slam_keys import CASES, bases, check_key  # noqa: F401  (bases: a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", sorted(k for k in CASES if not k.endswith("_rebin1")))
def test_config_key_rebin1_matches_jax(tmp_path, bases, case):  # noqa: F811
    check_key(tmp_path, bases, case, {"tpu": {"rebin_every": 1}})
