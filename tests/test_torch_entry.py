"""The port's single-card entry check (splatam_tpu_torch/scripts/entry.py)
against __graft_entry__.entry() on the CPU.

The JAX function renders through its `tiles` backend, the port through
K1's plain version; the same scene (seed 0, 2,048 Gaussians) and camera
give im, depth and silhouette within atol 1e-4, the tolerance the JAX
suite holds its own backends to.
"""
import numpy as np
import jax  # noqa: F401  (both frameworks in one process: import both first)
import pytest
import torch

import __graft_entry__ as graft
from splatam_tpu_torch.scripts import entry

torch.set_num_threads(1)


def test_entry_matches_jax_entry():
    jfn, jargs = graft.entry()
    fn, args = entry.entry("cpu")
    for got, ref in zip(args, jargs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with torch.no_grad():
        outs = fn(*args)
    refs = jax.jit(jfn)(*jargs)
    assert [tuple(o.shape) for o in outs] == [(3, 128, 160), (128, 160), (128, 160)]
    for got, ref in zip(outs, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert float(outs[2].max()) > 0.5  # the scene covers the image


def test_entry_main_on_the_cpu(capsys):
    outs = entry.main(["--device", "cpu"])
    line = capsys.readouterr().out
    assert "im (3, 128, 160)" in line and "finite=True" in line and "K1 launches 0" in line
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_entry_refuses_to_fall_back_to_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the entry would run on it")
    with pytest.raises(RuntimeError):
        entry.entry()
    with pytest.raises(SystemExit) as exc:
        entry.main([])
    assert exc.value.code == 2 and "--device cpu" in capsys.readouterr().err
