"""The port's roofline (`launch/roofline.py`, its own copy of the
reference's analytic half with H100 constants) against the reference's on
every arch × shape, to 1e-12 relative; and the reckoned dry-run
(`launch/dryrun.py`) on every arch × shape on the production meshes
(16, 16) and (2, 16, 16): every record "ok", or skipped where the
reference's own `should_skip` skips, and each tree's shards, every one
counted once over the 256 or 512 ranks, adding up to its unsharded bytes
exactly."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, get_shape as jget_shape
from repro.launch import roofline as jroofline
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.launch import dryrun, mesh as lmesh, roofline

# The reference's dry-run sets XLA_FLAGS for 512 host devices when it is
# imported; read its `should_skip` and leave this process's flags alone.
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCH_IDS = sorted(ARCHS)
REL = 1e-12


def close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_functions_match_the_reference(arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    sh, jsh = get_shape(shape), jget_shape(shape)
    for n in (1, 2):
        assert close(roofline.model_flops(cfg, sh, n),
                     jroofline.model_flops(jcfg, jsh, n))
    assert close(roofline.active_params(cfg), jroofline.active_params(jcfg))
    assert close(roofline._attn_params(cfg), jroofline._attn_params(jcfg))
    assert close(roofline._ffn_active(cfg), jroofline._ffn_active(jcfg))
    assert close(roofline.active_params_total(cfg),
                 jroofline.active_params_total(jcfg))
    for b in (1, 2):
        assert close(roofline._cache_bytes(cfg, sh, b),
                     jroofline._cache_bytes(jcfg, jsh, b))
    for n_dev, n_cl in ((1, 1), (256, 1), (512, 2)):
        got = roofline.memory_floor_bytes(cfg, sh, n_dev, n_clients=n_cl)
        want = jroofline.memory_floor_bytes(jcfg, jsh, n_dev, n_clients=n_cl)
        assert sorted(got) == sorted(want)
        assert all(close(got[k], want[k]) for k in want), (got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_variants_and_the_solver_match_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    cfgs, counts, names = roofline.depth_variants(cfg)
    jcfgs, jcounts, jnames = jroofline.depth_variants(jcfg)
    assert (counts, names) == (jcounts, jnames)
    assert [dataclasses.asdict(c) for c in cfgs] == [
        dataclasses.asdict(c) for c in jcfgs]
    rc = roofline.real_counts(cfg)
    assert rc == jroofline.real_counts(jcfg)
    rng = np.random.default_rng(len(arch))
    truth = {k: float(v) for k, v in zip(["fixed"] + names,
                                         rng.uniform(1e9, 1e12,
                                                     len(names) + 1))}
    values = [truth["fixed"] + sum(c.get(k, 0) * truth[k] for k in names)
              for c in counts]
    coefs = roofline.solve_linear(counts, names, values)
    jcoefs = jroofline.solve_linear(counts, names, values)
    assert sorted(coefs) == sorted(jcoefs)
    assert all(close(coefs[k], jcoefs[k]) for k in coefs)
    assert close(roofline.evaluate_linear(coefs, rc),
                 jroofline.evaluate_linear(jcoefs, rc))


def test_terms_read_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.terms({"flops": 989e12, "bytes accessed": 1.0},
                       {"total": 0})
    assert t["compute_s"] == 1.0 and t["bottleneck"] == "compute"
    t = roofline.terms({"flops": 1.0, "bytes accessed": 3.35e12 * 2},
                       {"total": 0})
    assert t["memory_s"] == 2.0 and t["bottleneck"] == "memory"
    t = roofline.terms(None, {"total": 450e9 * 3})
    assert t["collective_s"] == 3.0 and t["bottleneck"] == "collective"
    assert not hasattr(roofline, "collective_bytes")


@pytest.mark.parametrize("n,w", [(10, 4), (5, 4), (16, 16), (3, 8), (0, 2),
                                 (32000, 16), (22, 4)])
def test_a_split_is_torch_chunk(n, w):
    want = [len(c) for c in torch.chunk(torch.arange(n), w)]
    got = dryrun._chunks(n, w).tolist()
    assert got == want + [0] * (w - len(want))


def test_leaf_bytes_of_a_dim_split_over_two_mesh_dims():
    """A dim split over ("data", "model") is cut in mesh order, data-major,
    as `sharding.placements` declares it."""
    ms = lmesh.MeshShape(("data", "model"), (2, 3))
    b = dryrun.leaf_bytes((10, 4), 4, (("data", "model"), None), ms)
    # 10 over data -> 5, 5; each 5 over model -> 2, 2, 1
    assert b.tolist() == [[32, 32, 16], [32, 32, 16]]
    owned = (b * dryrun._owner_mask((("data", "model"), None), ms)).sum()
    assert owned == 10 * 4 * 4
    b = dryrun.leaf_bytes((8, 6), 2, (None, "model"), ms)
    assert b.tolist() == [[32, 32, 32]] * 2
    assert (b * dryrun._owner_mask((None, "model"), ms)).sum() == 8 * 6 * 2


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_reckons_every_combination(arch, shape, multi_pod):
    rec = dryrun.reckon_one(arch, shape, multi_pod=multi_pod)
    skip = jdryrun.should_skip(jget_arch(arch), jget_shape(shape))
    assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    if skip:
        assert rec["status"] == "skip" and rec["skip_reason"] == skip
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["shards_sum_exact"]
    for name, b in rec["bytes"].items():
        assert b["owned_sum"] == b["total"], name
        assert 0 < b["per_rank_min"] <= b["per_rank_max"] <= b["total"]
    n_clients = 2 if multi_pod else 1
    cfg, sh = get_arch(arch), get_shape(shape)
    assert rec["memory_floor"] == roofline.memory_floor_bytes(
        cfg, sh, rec["n_devices"], n_clients=n_clients)
    assert rec["model_flops_global"] == roofline.model_flops(cfg, sh,
                                                             n_clients)
    assert rec["per_rank_bytes"] == sum(b["per_rank_max"]
                                        for b in rec["bytes"].values())


def test_dryrun_main_writes_a_record_a_combination(tmp_path, capsys,
                                                  monkeypatch):
    from repro_torch import sharding
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "REMAT_POLICY", blocks.REMAT_POLICY)
    dryrun.main(["--arch", "granite-moe-1b-a400m", "--multi-pod",
                 "--strategy", "zero1", "--moe-ep", "--sync", "round",
                 "--remat", "dots", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "== dry-run summary: 4 ok / 0 skip / 0 fail ==" in out
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 4 and all("pod2x16x16__cors" in f for f in files)
    rec = json.load(open(tmp_path / files[0]))
    assert rec["knobs"] == {"strategy": "zero1", "moe_ep": True,
                            "sync": "round"}
    # main leaves no hint behind
    assert [sharding.hint(k) for k in ("mesh", "moe_ep", "moe_dp")] == [
        None, False, False]


def test_dryrun_one_step_runs_on_the_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    """`--one-step` defaults to the card: without a GPU it raises before
    joining any process group, and never falls to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--one-step", "--arch", "tinyllama-1.1b", "--shape",
                     "prefill_32k", "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    assert os.listdir(tmp_path) == []
