"""tests/test_torch_lm_mesh.py's four-rank checks on the xLSTM, reduced (an mLSTM and an sLSTM
layer, float32, prompts of two chunks): the mLSTM cell on each rank's
rows and heads, the sLSTM's whole scan under one `local_map`
(`nn/xlstm.py` on a mesh), at the same
bounds, in one four-rank run on the mesh (2, 2) over ("data", "model")
against the reference's unsharded JAX steps on the same weights.
"""
import pytest

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import check_serving, check_train, run_four_ranks_many

ARCHS = ("xlstm-125m",)
# The sLSTM's state (c, n, m, h) after its scan of 32 steps carries every
# ulp of its inputs forward: on these inputs the port's unsharded prefill
# is 3.03e-5 x max(1, |c|) from the reference's at one element (XLA's exp
# and tanh), and the mesh's, whose inputs come through the mLSTM's
# row-split w_down (a Partial sum in another order), 1.08e-5 from the
# unsharded port's. Against each leaf's largest value both stay under the
# bound (the mesh's at most 7.2e-6 x max(1, max|c|) from the reference's),
# so these four leaves are held so (`check_serving`'s `held`).
SLSTM_STATE = ("segments/1",)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(ARCHS, tmp_path_factory.mktemp("lm_xlstm"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(four_ranks, arch):
    check_serving(*four_ranks[arch], held=SLSTM_STATE)


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(four_ranks, arch, strategy):
    got, want = four_ranks[arch]
    check_train(got[strategy], want)
