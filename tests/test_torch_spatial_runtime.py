"""Row bands through the SLAM runtime, the banded dryrun, and the ported
measurement scripts at tiny sizes on the CPU.

- SLAMRuntime with tpu.spatial_shards = 2 (2 frames of
  tests/test_torch_slam.py's micro config, 64x48, rebin_every 1 and 8):
  against the JAX runtime and against the port's own run without bands,
  at test_torch_slam.py's tolerances (poses within 1e-4, equal active
  counts and keyframes).
- dryrun_multichip (__graft_entry__.py's counterpart) over 2 bands.
- profile_sharded, profile_map_ablate, probe_saturation, exp_gather and
  bands_multicard run their main at a tiny size with --device cpu (the
  plain versions; wall times only; bands_multicard's two placements are
  both the CPU there).
"""
import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from splatam_tpu_torch.scripts import (
    bands_multicard, dryrun_multichip, exp_gather, probe_saturation, profile_map_ablate,
    profile_sharded,
)
from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame
from test_torch_slam import _config, run_both

torch.set_num_threads(1)

FRAMES = 2
TINY = ["--device", "cpu", "--h", "48", "--w", "64"]


def _port_run(config, frames=FRAMES):
    seed_everything(0)
    rt = SLAMRuntime(config, "cpu")
    active = []
    for i in range(frames):
        run_frame(rt, i)
        active.append(rt.gm.num_active())
    return rt, active


@pytest.mark.parametrize("rebin_every", [1, 8])
def test_runtime_with_two_bands_matches_jax_and_unbanded(tmp_path, capsys, rebin_every):
    """At rebin_every=1 the JAX runtime runs on its mesh too; at 8 it
    cannot (its tracking_phase returns the per-shard pair counts of a
    sharded structure, which pipeline.py:556 reads as one int: TypeError),
    so there the port's bands are held to the JAX runtime without a mesh."""
    tpu = {"rebin_every": rebin_every}
    banded = dict(tpu, spatial_shards=2)
    if rebin_every == 1:
        rt, jrt, t_active, j_active = run_both(tmp_path, frames=FRAMES, tpu=banded)
        assert jrt.mesh is not None
        ref, r_active = _port_run(_config(tmp_path / "unbanded", tpu=tpu))
    else:
        ref, jrt, r_active, j_active = run_both(tmp_path, frames=FRAMES, tpu=tpu)
        rt, t_active = _port_run(_config(tmp_path / "banded", tpu=banded))
    assert "rendering in 2 row bands of [32, 16] rows on cpu, cpu" in (
        capsys.readouterr().out)
    assert rt.bands == [torch.device("cpu")] * 2 and ref.bands is None
    assert t_active == j_active == r_active
    for other in (jrt, ref):
        np.testing.assert_allclose(rt.cam_rots[:FRAMES], other.cam_rots[:FRAMES], atol=1e-4)
        np.testing.assert_allclose(rt.cam_trans[:FRAMES], other.cam_trans[:FRAMES], atol=1e-4)
        assert [k["id"] for k in rt.keyframe_list] == [k["id"] for k in other.keyframe_list]
    assert np.abs(rt.cam_trans[1]).max() > 1e-3  # the camera moved


def test_dryrun_multichip_two_bands(capsys):
    out = dryrun_multichip.main(["--device", "cpu", "--bands", "2"])
    assert "dryrun_multichip ok: 2 bands on cpu, cpu" in capsys.readouterr().out
    assert out["capacities"] == [out["capacities"][0], 2 * out["capacities"][0]]
    assert out["added"] > 0 and out["delta"] > 0
    assert np.isfinite(out["tracking_loss"]) and np.isfinite(out["mapping_loss"])


def test_profile_sharded_main(capsys):
    rows = profile_sharded.main(TINY + ["--n", "2000", "--shards", "1", "2", "4", "--iters", "1",
                                        "--map_iters", "1", "--reps", "1"])
    assert [r["shards"] for r in rows] == [1, 2, 4]
    base = rows[0]["pairs_total"]
    for r in rows:
        assert len(r["pairs"]) == r["shards"] and r["pairs_total"] >= base
        assert r["times"]["tracking fwd+bwd"].event is None  # no device time on the CPU
    assert "the latency on 4 cards is not measured here" in capsys.readouterr().out


def test_profile_map_ablate_main():
    out = profile_map_ablate.main(TINY + ["--n", "5000", "--iters", "1", "--reps", "1"])
    assert len(out) == 5 and all(tm.wall > 0 and tm.event is None for tm in out.values())


def test_probe_saturation_main():
    r = probe_saturation.main(TINY + ["--frames", "2", "--track_iters", "2", "--map_iters", "2"])
    assert r["tiles"] == 12 and r["total"] == int(r["lens"].sum()) > 0
    kept = [r["trimmed"][s] for s in probe_saturation.SLACKS]
    assert kept == sorted(kept) and kept[-1] <= r["total"]
    assert (r["nc_tile"] <= r["lens"]).all()


def test_exp_gather_main():
    out = exp_gather.main(TINY + ["--p", "4096", "--n", "5000", "--iters", "1", "--reps", "1"])
    assert len(out["tables"]) == 6 and out["tracking"]["n_pairs"] > 0
    assert out["tracking"]["gathered_ms"] > 0 and out["tracking"]["direct_ms"] > 0


def test_bands_multicard_main(capsys):
    assert bands_multicard.main(TINY + ["--n", "2000", "--shards", "2", "--frames", "2",
                                        "--track_iters", "2", "--map_iters", "2"])
    out = capsys.readouterr().out
    assert "2 bands, generic: loss" in out and "bands_multicard ok" in out
