"""The dry-run's `--one-step` on families other than GQA: two gloo CPU
ranks on the mesh (2, 1, 1) over ("pod", "data", "model") run one step of
each shape of tests/torch_lm_mesh_ranks.py's DRYRUN (Zamba2, mamba2 and the
shared attention block; DeepSeek-V2-Lite, MLA beside MoE) through
`dryrun._run_record`, as `python -m repro_torch.launch.dryrun --one-step
--mesh 2x1x1 --device cpu` records them under torchrun: every record ran,
its outputs finite and its collectives counted by mesh axis; the train
step's bytes over "pod" are the prototype sums and counts, C (d' + 1)
floats, as tests/test_torch_lm_pod_bytes.py reads them for TinyLlama.
(Serving splits the batch over "pod"; what crosses it there is the
reference's specs' doing: MoE's balance loss, a batch mean, and zamba2's
shared-block cache, whose unstacked leaf the cache rule does not split on
the batch, so the decode's new row is gathered to it.)
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch
import torch_lm_mesh_ranks as lmr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(a, s) for a, shapes in lmr.DRYRUN for s in shapes]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("lm_dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_lm_mesh_ranks.py"),
         "dryrun", str(d / "out.pt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "DRYRUN_OK" in out.stdout.split()
    recs = torch.load(d / "out.pt", weights_only=False)
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.mark.parametrize("arch,shape", CASES)
def test_one_step_record_is_finite_and_reckoned(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["status"] == "ok" and rec["finite"], rec.get("error")
    assert rec["ran"] == "pod:2xdata:1xmodel:1"
    assert rec["terms"]["compute_s"] > 0 and rec["terms"]["memory_s"] > 0
    pod = rec["collectives_beyond_scalars"]["pod"]
    assert set(rec["collectives"]) == {"pod", "data", "model"}
    if shape == "train_4k":
        cfg = get_arch(arch).reduced()
        assert pod["total"] == pod["all-reduce"] == (
            cfg.vocab_size * (cfg.d_feature + 1) * 4), pod
