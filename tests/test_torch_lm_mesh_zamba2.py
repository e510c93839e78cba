"""tests/test_torch_lm_mesh.py's four-rank checks on Zamba2, reduced (2 mamba2 layers and the
shared attention block after them, float32, prompts of two SSD chunks):
the block's core on each rank's rows, the decode's state update on its
block of the state (`nn/ssm.py` on a mesh), the shared block's caches, at the same
bounds, in one four-rank run on the mesh (2, 2) over ("data", "model")
against the reference's unsharded JAX steps on the same weights.
"""
import pytest

from repro_torch.configs import get_arch

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import (check_serving, check_step, check_train,
                                run_four_ranks_many)

ARCHS = ("zamba2-1.2b",)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(ARCHS, tmp_path_factory.mktemp("lm_zamba2"),
                               pod=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(four_ranks, arch):
    check_serving(*four_ranks[arch])


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(four_ranks, arch, strategy):
    got, want = four_ranks[arch]
    check_train(got[strategy], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_train_step_matches_the_reference(four_ranks, arch):
    """The cors step with a client a pod on the mesh (2, 1, 2) ("pod",
    "data", "model"), tensor parallel over "model": the step's outputs as
    the reference's unsharded step, and over "pod" only this rank's vocab
    block of the prototype sums and counts."""
    got, want = four_ranks[arch]
    check_step(got["pod"], want)
    cfg = get_arch(arch).reduced()
    pod = got["pod"]["payload"]["pod"]
    assert pod["total"] == pod["all-reduce"] == (
        cfg.vocab_size // 2 * (cfg.d_feature + 1) * 4), pod
