"""tests/test_torch_lm_mesh.py's four-rank checks on the two MLA models, DeepSeek-V2-Lite (MLA
beside MoE with a shared expert, no query compression) and MiniCPM3 (MLA,
dense), reduced (2 layers, float32): the expanded prefill through the
kernel on head-split q, k and v, the absorbed decode on each rank's block
of the latent cache (`nn/mla.py` on a mesh), at the same
bounds, in one four-rank run on the mesh (2, 2) over ("data", "model")
against the reference's unsharded JAX steps on the same weights.
"""
import pytest

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import check_serving, check_train, run_four_ranks_many

ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(ARCHS, tmp_path_factory.mktemp("lm_mla"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(four_ranks, arch):
    check_serving(*four_ranks[arch])


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(four_ranks, arch, strategy):
    got, want = four_ranks[arch]
    check_train(got[strategy], want)
