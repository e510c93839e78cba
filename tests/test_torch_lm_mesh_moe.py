"""tests/test_torch_lm_mesh.py's four-rank checks on the reduced Granite
MoE (2 layers, float32): the router, the row-local dispatch and combine
and the expert products (`nn/moe.py` on a mesh), at the same bounds.

The same run also serves and takes one "tp" step under the
expert-parallel hint ("moe_ep"): each rank holds E / 2 of the 4 experts of
every `_e` leaf (`sharding.layer_spec` splits the expert dim over "model",
where the reference's stacked spec would put "model" on the layer axis),
every `_experts` call sees the weights split on experts, and the outputs
are held against the reference's unsharded steps at the same bounds.
"""
import pytest

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import check_serving, check_train, run_four_ranks_many

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many((ARCH,), tmp_path_factory.mktemp("lm_moe"),
                               moe_ep=(ARCH,))[ARCH]


def test_prefill_and_decode_match_the_reference(four_ranks):
    check_serving(*four_ranks)


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
def test_train_step_matches_the_reference(four_ranks, strategy):
    check_train(four_ranks[0][strategy], four_ranks[1])


def test_moe_ep_splits_the_experts(four_ranks):
    got = four_ranks[0]["moe_ep"]
    # 3 leaves a layer, 2 layers; 4 experts over "model" of 2
    assert got["local_experts"] == [2] * 6
    # ("data", "model"): the experts split on "model" at every call
    assert got["placements"] and all(p[1] == "S(0)"
                                     for p in got["placements"]), \
        got["placements"]


def test_moe_ep_serving_matches_the_reference(four_ranks):
    check_serving(four_ranks[0]["moe_ep"], four_ranks[1])


def test_moe_ep_train_step_matches_the_reference(four_ranks):
    check_train(four_ranks[0]["moe_ep"]["tp"], four_ranks[1])
