"""The plain references against themselves at a reduced size: the LM's
last-position logits equal the whole forward's last row and do not see
later tokens; the fleet's clients, batched on a client axis, evolve as
each alone does when nothing couples them (il); the control's rounding
moves the answer, the float32 path leaves it."""
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import images, lm_weights  # noqa: E402
from ref import granite, lenet_cors, precision  # noqa: E402

LM = dict(hidden_size=32, num_attention_heads=2, num_key_value_heads=1,
          head_dim=16, num_hidden_layers=2, num_local_experts=4,
          num_experts_per_tok=2, intermediate_size=16, vocab_size=64,
          torch_dtype="float32", rope_theta=10000.0, rms_norm_eps=1e-5,
          capacity_factor=1.5, router_aux_loss_coef=0.01)
FLEET = {"image": 28, "in_channels": 1, "conv_channels": [6, 16],
         "fc_width": 120, "d_feature": 84, "num_classes": 10,
         "batch_size": 16, "samples_per_client": 32, "test_samples": 40,
         "noise": 0.8, "modes": 4, "lr": 1e-3, "beta1": 0.9,
         "beta2": 0.999, "eps": 1e-8, "lambda_kd": 2.0, "lambda_disc": 1.0,
         "n_avg": 10, "m_up": 1, "m_down": 1}


def test_lm_last_logits_are_the_forward_last_row_and_causal():
    torch.manual_seed(0)
    p = lm_weights.make(LM, 7, "cpu")
    tok = torch.randint(0, 64, (2, 12))
    with torch.no_grad():
        _, z, _ = granite.forward(p, tok, LM)
    last = granite.prefill_logits(p, tok, LM)
    torch.testing.assert_close(last, z[:, -1], rtol=1e-5, atol=1e-5)
    tok2 = tok.clone()
    tok2[:, 8:] = (tok2[:, 8:] + 1) % 64
    with torch.no_grad():
        _, z2, _ = granite.forward(p, tok2, LM)
    torch.testing.assert_close(z2[:, :8], z[:, :8], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(z2[:, 8:], z[:, 8:])


def test_fleet_clients_batched_evolve_as_each_alone():
    traffic = {"mode": "il"}
    inp = images.fleet_inputs(5, 3, FLEET, "cpu")
    whole = lenet_cors.run_rounds(FLEET, traffic, 5, inp["params"], inp, 2)
    for i in range(3):
        one = {"params": {k: v[i:i + 1] for k, v in inp["params"].items()},
               "x": inp["x"][i:i + 1], "y": inp["y"][i:i + 1],
               "test_x": inp["test_x"], "test_y": inp["test_y"]}
        alone = lenet_cors.run_rounds(FLEET, traffic, 5, one["params"], one,
                                      2)
        assert [a[i] for a in whole["accs"]] == [a[0] for a in alone["accs"]]


def test_rounding_moves_values_and_float32_leaves_them():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    assert torch.equal(precision.operand(x, "float32"), x)
    big = x.abs() > 0.1 * x.abs().max()      # normal numbers in e4m3 too
    for prec, rel in (("tf32", 2.0 ** -11), ("fp8", 2.0 ** -4)):
        y = precision.operand(x, prec)
        err = ((y - x).abs() / x.abs())[big].max()
        assert 0 < err <= rel * 1.0001
        assert not torch.equal(y, x)
