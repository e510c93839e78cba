"""tests/test_torch_lm_mesh.py's four-rank checks on the reduced Granite
MoE (2 layers, float32): the router, the row-local dispatch and combine
and the expert products (`nn/moe.py` on a mesh), at the same bounds."""
import pytest

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import check_serving, check_train, run_four_ranks_many


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(("granite-moe-1b-a400m",),
                               tmp_path_factory.mktemp("lm_moe"))[
        "granite-moe-1b-a400m"]


def test_prefill_and_decode_match_the_reference(four_ranks):
    check_serving(*four_ranks)


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
def test_train_step_matches_the_reference(four_ranks, strategy):
    check_train(four_ranks[0][strategy], four_ranks[1])
