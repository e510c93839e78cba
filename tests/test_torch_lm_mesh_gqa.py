"""tests/test_torch_lm_mesh.py's four-rank checks on the GQA variants, reduced (2 layers,
float32): ChatGLM3 (its 2-D partial rope, two KV heads), Qwen2-VL (a
batch of embeddings with M-RoPE positions) and DeepSeek-67B, at the same
bounds, in one four-rank run on the mesh (2, 2) over ("data", "model")
against the reference's unsharded JAX steps on the same weights.
"""
import pytest

import torch_lm_mesh_ranks as lmr
from test_torch_lm_mesh import check_serving, check_train, run_four_ranks_many

ARCHS = ("chatglm3-6b", "qwen2-vl-7b", "deepseek-67b")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_four_ranks_many(ARCHS, tmp_path_factory.mktemp("lm_gqa"))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(four_ranks, arch):
    check_serving(*four_ranks[arch])


@pytest.mark.parametrize("strategy", lmr.STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(four_ranks, arch, strategy):
    got, want = four_ranks[arch]
    check_train(got[strategy], want)
