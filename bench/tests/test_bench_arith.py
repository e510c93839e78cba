"""The benchmark's arithmetic on small shapes against counts made by hand,
the isolation check's whole-name comparison, and the trace reduction on a
made-up timeline."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import check, flops, isolation  # noqa: E402
from benchlib.trace import Trace  # noqa: E402

LENET = {"image": 28, "in_channels": 1, "conv_channels": [6, 16],
         "fc_width": 120, "d_feature": 84, "num_classes": 10}
TINY_LM = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4, "num_local_experts": 4,
           "num_experts_per_tok": 2, "intermediate_size": 3,
           "num_hidden_layers": 2, "vocab_size": 10}


def test_lenet_macs_by_hand():
    # conv1 24x24x6 outputs of 5x5x1; conv2 8x8x16 of 5x5x6; 4x4x16 -> 120;
    # 120 -> 84; 84 -> 10
    assert flops.lenet_macs(LENET) == (86400, 153600, 30720, 10080, 840)


def test_lenet_flops_by_hand():
    fwd = 2 * 281640
    # training: forward, weight gradients, input gradients past conv1
    train = fwd + 2 * 281640 + 2 * (281640 - 86400)
    assert flops.lenet_flops(LENET, 3, 5) == 3 * train + 5 * fwd


def test_lm_params_by_hand():
    # attention: q 8x8, k and v 8x4 each, o 8x8 -> 64 + 32 + 32 + 64 = 192;
    # experts: 3 x 8 x 3 x 2 active = 144, router 8 x 4 = 32
    assert flops.lm_layer_params(TINY_LM) == 192 + 144 + 32
    # two layers and the head (8 x 10); no embedding
    assert flops.lm_active_params(TINY_LM) == 2 * 368 + 80


def test_attention_and_step_flops_by_hand():
    assert flops.causal_pairs(4) == 10
    # 4 H hd a pair, 3 rows, 2 layers
    assert flops.attention_flops(TINY_LM, 3, 4) == 4 * 2 * 4 * 10 * 3 * 2
    assert flops.lm_train_flops(TINY_LM, 3, 4) == \
        6 * 816 * 12 + 3 * 4 * 2 * 4 * 10 * 3 * 2
    assert flops.lm_prefill_flops(TINY_LM, 3, 4) == \
        2 * 816 * 12 + 4 * 2 * 4 * 10 * 3 * 2


def test_kernel_costs_by_hand():
    ops, byt = flops.flash_cost(1, 2, 2, 1, 4, 4, 2)
    assert ops == 2 * 2 * 8 * 3                   # 3 causal pairs a head
    assert byt == 2 * 2 * (8 + 4 + 4 + 8)
    ops, byt = flops.proto_accum_cost(1, 3, 2, 5)
    assert ops == 3 * 3
    assert byt == 4 * 6 + 4 * 3 + 4 * 10 + 4 * 5
    ops, byt = flops.disc_fwd_cost(1, 2, 3, 3)
    assert ops == 2 * (12 + 18 + 9)
    assert byt == 4 * (6 + 9) + 4 * 2 + 3 + 4 * (6 + 6)
    ops, byt = flops.disc_bwd_cost(1, 2, 3, 3)
    assert ops == 2 * (9 + 24 + 36)
    assert byt == 4 * (6 + 6 + 9 + 6) + 4 * 2 + 3 + 4 * (6 + 9)


def test_leaf_gaps_by_hand():
    ref = {"a": 4.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 5.0, "b": 2.0, "c": 1.0}
    # the median leaf's norm (2) stands in for a leaf that is all but zero
    assert check.worst_leaf_gap(prog, ref) == pytest.approx(0.5)
    assert check.worst_leaf_gap(prog, ref, ["a", "b"]) == pytest.approx(0.25)
    assert check.median_leaf_gap(prog, ref) == pytest.approx(0.25)
    assert check.moving({"a": 4.0, "b": 2.0, "c": 1e-9}) == ["a", "b"]


def test_least_seconds_takes_the_slower_bound():
    assert flops.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert flops.least_seconds(67e12, 3.35e12 / 2, "float32") == \
        pytest.approx(1.0)


@pytest.mark.parametrize("mods,bad", [
    (["repro_torch", "repro_torch.kernels.ops", "reprox"], []),
    (["repro", "repro.core"], ["repro", "repro.core"]),
    (["jax.numpy", "jaxtyping", "jaxlib.xla_client"],
     ["jax.numpy", "jaxlib.xla_client"]),
    (["flax.linen", "flaxen"], ["flax.linen"])])
def test_isolation_compares_whole_top_level_names(mods, bad):
    assert isolation.forbidden_loaded(mods) == bad


def test_trace_busy_idle_and_kernel_time():
    import re
    dev = [("k_a", 0.0, 1.0), ("k_b", 0.5, 2.0), ("disc_fwd_small", 3.0, 3.5),
           ("x", 9.0, 11.0)]
    host = [("round_step", -1.0, 5.0, True), ("aten::mm", 2.0, 3.0, False)]
    tr = Trace(dev, host, launches=4, window=(0.0, 10.0))
    assert tr.busy_s == pytest.approx(2.0 + 0.5 + 1.0)
    assert tr.window_s == 10.0
    n, s = tr.kernel_seconds(re.compile(r"(?<![A-Za-z0-9_])disc_fwd_small"
                                        r"(?![A-Za-z0-9_])"))
    assert (n, s) == (1, 0.5)
    gaps = dict(tr.idle_gaps())
    assert gaps["round_step/aten::mm"] == pytest.approx(1.0)
    assert sum(gaps.values()) == pytest.approx(10.0 - 3.5)
    assert tr.top_device_ops(1)[0] == ["x", 2.0]


def test_train_device_time_a_token_and_window_rate_by_hand():
    from benchlib import spec
    lm_train = spec.load_runner("lm_train")
    # two steps of 2 x 2048 tokens on 2.1 s of device time
    assert lm_train.device_us_per_token(2.1, 2, 4096) == \
        pytest.approx(1e6 * 2.1 / 8192)
    rate = spec.load_reader("tokens_per_s.train")

    class Window:
        work, seconds = 61440.0, 30.5

    class Run:
        window = Window()
    assert rate(Run()) == pytest.approx(61440.0 / 30.5)
    Window.seconds = 0.0
    assert rate(Run()) is None
