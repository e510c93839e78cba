"""Training of Whisper, the port's encoder-decoder (`launch/train.py`'s
encoder-decoder branch: `encdec.encode` and `decode_forward(mode="train")`
under autograd), against the reference, on the CPU, in float32, at the
reference's `reduced()` sizes with vocabulary and width 64 (2 + 2 layers,
8 frames), as tests/test_torch_train.py's TinyLlama.

Weights come from the reference's `init_state` through
`convert.train_state_from_jax`; tokens, labels and frames (2 clients x B 2
x S 32, 8 frames a clip) from a numpy seed; the negative classes are the
reference's own draws. Tolerances are tests/test_torch_train.py's (see
tests/test_torch_family_train.py, whose checks these are); the state's
conversion and its checkpoint keys are exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.nn import attention
from repro_torch.tree import leaves
from test_torch_family_train import (_batch, _start, check_gradients,
                                     check_train_step)
from test_torch_train import (D, N, V, _ccfgs, _np,
                              one_torch_thread)  # noqa: F401


def _cfgs():
    cfg = get_arch("whisper-small").reduced(vocab_size=V, d_model=D)
    jcfg = jget_arch("whisper-small").reduced(vocab_size=V, d_model=D)
    assert cfg.__dict__ == jcfg.__dict__ and cfg.is_encoder_decoder
    return cfg, jcfg


@pytest.mark.parametrize("mode", ["cors", "fd"])
def test_loss_and_gradients_match_reference(mode, monkeypatch):
    """Every client's gradients before Adam, encoder and decoder, against
    jax.value_and_grad of the reference's loss; no call reaches the prefill
    attention (the kernel, which has no backward)."""
    calls = []

    def no_kernel(q, k, v, causal=True):
        calls.append(q.shape)
        raise AssertionError("train mode reached the prefill attention")

    with attention.prefill_attention(no_kernel):
        grads = check_gradients(_cfgs(), monkeypatch, mode)
    assert calls == []
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))
    assert float(grads["enc_layers"][0]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("mode,sync", [("cors", True), ("cors", False),
                                       ("fedavg", True)])
def test_train_step_matches_reference(mode, sync):
    check_train_step(_cfgs(), mode, sync)


def test_train_state_converts_both_ways_under_the_reference_keys(tmp_path):
    """train_state_from_jax then train_state_to_numpy gives back the
    reference's TrainState leaf for leaf under its checkpoint keys; the
    port's checkpoint of the converted state loads in the reference onto
    its template, bit for bit."""
    cfg, jcfg = _cfgs()
    js, ts = _start(jcfg)
    assert len(ts.params["enc_layers"]) == cfg.num_encoder_layers
    assert ts.params["dec_layers"][0]["cross_attn"]["wk"].shape == (N, D, D)
    want = jio._paths(_np(js))
    back = tio._paths(convert.train_state_to_numpy(ts))
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]),
                                      err_msg=k)
    path = tmp_path / "state"
    tio.save_pytree(str(path), convert.train_state_to_numpy(ts))
    loaded = jio.load_pytree(str(path), js)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_shapes_and_batch_specs_at_a_frame_count_of_20():
    """`encoder_seq` through `dataclasses.replace`: the batch specs carry
    20 frames a clip, and one train step runs on them."""
    cfg = dataclasses.replace(_cfgs()[0], encoder_seq=20)
    from repro_torch.types import ShapeConfig
    specs = train.train_batch_specs(cfg, ShapeConfig("t", 16, 4, "train"), N)
    assert tuple(specs["frames"].shape) == (N, 2, 20, D)
    state = train.init_state(cfg, torch.Generator().manual_seed(0), N,
                             device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3, S=16).items()}
    assert tuple(b["frames"].shape) == (N, 2, 20, D)
    ccfg, _ = _ccfgs("cors")
    neg = train.draw_negatives(torch.Generator().manual_seed(1), cfg, ccfg, N)
    new, m = train.make_train_step(cfg, ccfg, n_clients=N,
                                   disc_tokens=16)(state, b, neg)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(new.params["lm_head"], state.params["lm_head"])
    assert int(new.proto.count.sum()) == N * 2 * 16
