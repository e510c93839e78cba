"""The port's LM serving path against the reference's, on the CPU.

Weights come from the reference's `init_lm` through
`convert.lm_params_from_jax`; inputs from a numpy seed. Tolerances:
- layers and rope: 1e-5 (atol and rtol), float32 math in another order;
- `lm.forward` (train and prefill: logits and every cache leaf) and
  `decode_step` on the reduced TinyLlama (float32): 1e-4, two layers of
  float32 products summed in another order;
- the port's own decode-consistency property: 2e-3, the reference's
  tolerance for the same property (tests/test_decode_consistency.py);
- the serving twin against the reference's serving loop: generated ids
  equal, logits within 2e-3.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.nn import layers as jlayers, rope as jrope
from repro_torch import convert, serve_lm
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import blocks, lm
from repro_torch.nn import layers, rope
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LM_TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """The reduced TinyLlama in both packages, same weights."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    jcfg = jget_arch("tinyllama-1.1b").reduced()
    assert cfg == type(cfg)(**jcfg.__dict__)
    jp = jlm.init_lm(KEY, jcfg)
    return cfg, jcfg, jp, convert.lm_params_from_jax(_np(jp), device="cpu")


# -- layers and rope ----------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    if kind == "rmsnorm":
        p.pop("bias")
    want = np.asarray(jlayers.apply_norm(kind, p, x, 1e-5))
    got = layers.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x),
                            1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # bf16 in, bf16 out, f32 inside
    xb = _t(x).to(torch.bfloat16)
    assert layers.apply_norm(kind, {k: _t(v) for k, v in p.items()}, xb,
                             1e-5).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlps_match_reference(kind):
    jp = _np(jlayers.init_mlp(kind, KEY, 32, 80, jnp.float32))
    rng = np.random.default_rng(1)
    jp = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in jp.items()}                 # nonzero biases
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(kind, jp, x))
    got = layers.apply_mlp(kind, {k: _t(v) for k, v in jp.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["rope", "rope2d", "mrope", "none"])
def test_rope_matches_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    jpos = np.asarray(jrope.default_positions(2, 9, kind, offset=5))
    want = np.asarray(jrope.apply_rope(x, jpos, theta=10000.0, kind=kind))
    pos = rope.default_positions(2, 9, kind, offset=5)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    got = rope.apply_rope(_t(x), pos, theta=10000.0, kind=kind)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_mrope_with_distinct_axes_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 6, 2, 64)).astype(np.float32)
    pos = rng.integers(0, 50, (1, 6, 3)).astype(np.int32)
    want = np.asarray(jrope.apply_rope(x, pos, theta=1e6, kind="mrope"))
    got = rope.apply_rope(_t(x), _t(pos), theta=1e6, kind="mrope")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_token_stream_is_bit_identical():
    for n, vocab, seed in ((5000, 512, 1), (1500, 32000, 7)):
        np.testing.assert_array_equal(
            synthetic.token_stream(n, vocab=vocab, seed=seed),
            jsyn.token_stream(n, vocab=vocab, seed=seed))


# -- configs and conversion ---------------------------------------------------
def test_configs_match_reference_and_unported_archs_raise():
    """Every arch of the reference's registry, the encoder-decoder
    Whisper-small too, equals the reference's field for field; an unknown
    name raises."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS
    full = get_arch("tinyllama-1.1b")
    assert full.head_dim == 64 and full.num_layers == 22
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        assert get_arch(name).__dict__ == jget_arch(name).__dict__, name
    assert get_arch("whisper-small").is_encoder_decoder
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_lm_params_from_jax_unstacks_layers(model):
    cfg, _, jp, p = model
    assert len(p["segments"]) == 1 and len(p["segments"][0]) == cfg.num_layers
    for i, layer in enumerate(p["segments"][0]):
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(),
            np.asarray(jp["segments"][0]["attn"]["wq"][i]))
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    bf = convert.lm_params_from_jax(
        _np(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.bfloat16).astype(jnp.float32)))


def test_unported_layers_raise():
    """mamba, MLA and MoE layers train as they serve (parity in
    tests/test_torch_family_train.py): train mode gives x's shape, MoE its
    balance loss as a tensor with a gradient, the others 0.0; the xLSTM
    kinds train and serve (tests/test_torch_xlstm.py)."""
    import dataclasses
    base = get_arch("tinyllama-1.1b").reduced()
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(1, 4, base.d_model)
    pos = rope.default_positions(1, 4, "rope")
    for cfg, kind in ((dataclasses.replace(base, ssm_state=16), "mamba"),
                      (dataclasses.replace(base, attn_kind="mla",
                                           kv_lora_rank=32, qk_rope_dim=16,
                                           qk_nope_dim=64), "attn"),
                      (dataclasses.replace(base, num_experts=4,
                                           experts_per_token=2,
                                           moe_d_ff=64), "attn")):
        p = blocks.init_block(gen, cfg, kind, torch.float32)
        p = tree_map(lambda a: a.requires_grad_(True), p)
        y, aux, cache = blocks.apply_block(p, cfg, kind, x, pos, mode="train")
        assert y.shape == x.shape and y.requires_grad and cache is None
        if cfg.num_experts:
            assert aux.requires_grad and float(aux.detach()) > 0
        else:
            assert aux == 0.0
        y, _, _ = blocks.apply_block(p, cfg, kind, x, pos, mode="prefill")
        assert y.shape == x.shape
    for kind in ("mlstm", "slstm"):
        p = blocks.init_block(gen, base, kind, torch.float32)
        for mode in ("train", "prefill"):
            y = blocks.apply_block(p, base, kind, x, None, mode=mode)[0]
            assert y.shape == x.shape


# -- the model ----------------------------------------------------------------
def _tokens(cfg, B=2, S=12, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_reference(model, mode):
    cfg, jcfg, jp, p = model
    toks = _tokens(cfg)
    want = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, mode=mode)
    got = lm.forward(p, cfg, {"tokens": _t(toks)}, mode=mode)
    for name in ("logits", "features"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=LM_TOL, rtol=LM_TOL)
    if mode == "train":
        assert got["caches"] is None
        return
    jleaves = jax.tree.leaves(want["caches"])
    leaves = [a for seg in got["caches"]["segments"] for a in seg]
    assert len(leaves) == len(jleaves) == 2
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LM_TOL,
                                   rtol=LM_TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_decode_step_matches_reference(model, masked):
    cfg, jcfg, jp, p = model
    toks = _tokens(cfg, S=9)
    jpre = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                       mode="prefill")
    jc = jlm.pad_cache_for_decode(jcfg, jpre["caches"])
    jc = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 3), (0, 0),
                                           (0, 0)]), jc)       # 12 slots
    kw = dict(cache_index=8, masked=True) if masked else {}
    want = jlm.decode_step(jp, jcfg, {"tokens": jnp.asarray(toks[:, 8:])}, jc,
                           **{k: (jnp.asarray(v) if k == "cache_index" else v)
                              for k, v in kw.items()})
    caches = {"segments": [tuple(_t(a) for a in seg)
                           for seg in _np(jc)["segments"]], "shared": []}
    got = lm.decode_step(p, cfg, {"tokens": _t(toks[:, 8:])}, caches, **kw)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=LM_TOL,
                               rtol=LM_TOL)
    for a, b in zip(got["caches"]["segments"][0],
                    want["caches"]["segments"][0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LM_TOL,
                                   rtol=LM_TOL)


def test_decode_appends_exactly(model):
    """prefill(S-1) + pad + one decode step == forward(S) at the last
    position, in the port alone."""
    cfg, _, _, p = model
    toks = _t(_tokens(cfg, S=12, seed=5))
    full = lm.forward(p, cfg, {"tokens": toks}, mode="train")
    pre = lm.forward(p, cfg, {"tokens": toks[:, :11]}, mode="prefill")
    padded = lm.pad_cache_for_decode(cfg, pre["caches"])
    assert padded["segments"][0][0].shape[2] == 12
    dec = lm.decode_step(p, cfg, {"tokens": toks[:, 11:]}, padded)
    np.testing.assert_allclose(dec["logits"][:, 0].numpy(),
                               full["logits"][:, -1].numpy(), atol=2e-3,
                               rtol=2e-3)


def test_init_cache_and_steps_of_serve(model):
    cfg, _, _, p = model
    c = lm.init_cache(cfg, 3, 20, device="cpu")
    assert c["segments"][0][0].shape == (cfg.num_layers, 3, 20,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert lm._cache_len(cfg, c) == 20
    toks = _t(_tokens(cfg, B=3, S=5))
    out = serve.make_prefill_step(cfg)(p, {"tokens": toks})
    assert out["logits"].shape == (3, 1, cfg.vocab_size)
    from repro_torch.types import ShapeConfig
    assert serve.decode_window(cfg, ShapeConfig("x", 1 << 19, 1, "decode")) \
        == cfg.swa_window
    assert serve.decode_window(cfg, ShapeConfig("x", 4096, 1, "decode")) == 0


def _reference_serve(jcfg, jp, prompts, tokens):
    """The loop of examples/serve_lm.py:main, on given weights and prompts."""
    spec = importlib.util.spec_from_file_location(
        "reference_serve_lm", ROOT / "examples" / "serve_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = jserve.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(prompts)})
    caches = ex._grow_caches(jcfg, out["caches"], tokens)
    logits = out["logits"]
    ids, all_logits = [], [np.asarray(logits[:, -1])]
    for i in range(tokens):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1)[:, None]
        ids.append(np.asarray(nxt)[:, 0])
        out = jlm.decode_step(jp, jcfg, {"tokens": nxt}, caches,
                              cache_index=jnp.asarray(prompts.shape[1] + i,
                                                      jnp.int32), masked=True)
        logits, caches = out["logits"], out["caches"]
        all_logits.append(np.asarray(logits[:, -1]))
    return np.stack(ids, 1), np.stack(all_logits)


def test_serving_twin_matches_reference_loop():
    """The example's reduced config (2 layers, d_model 256, vocab 512),
    prompts cut from token_stream as the example cuts them."""
    cfg = get_arch("tinyllama-1.1b").reduced(num_layers=2, d_model=256,
                                             vocab_size=512)
    jcfg = jget_arch("tinyllama-1.1b").reduced(num_layers=2, d_model=256,
                                               vocab_size=512)
    jp = jlm.init_lm(KEY, jcfg)
    p = convert.lm_params_from_jax(_np(jp), device="cpu")
    prompts = serve_lm.make_prompts(cfg, 4, 32)
    stream = jsyn.token_stream(10_000, vocab=512, seed=1)
    np.testing.assert_array_equal(
        prompts, np.stack([stream[i * 100:i * 100 + 32] for i in range(4)]))
    want_ids, want_logits = _reference_serve(jcfg, jp, prompts, 8)
    before = dict(ops.LAUNCHES)
    r = serve_lm.serve(p, cfg, prompts, 8)
    assert ops.LAUNCHES == before                  # CPU: the plain version
    np.testing.assert_array_equal(r["ids"].numpy(), want_ids)
    np.testing.assert_allclose(r["logits"].numpy(), want_logits, atol=2e-3,
                               rtol=2e-3)


def test_reduced_flag_can_be_turned_off():
    assert serve_lm.parser().parse_args([]).reduced is True
    assert serve_lm.parser().parse_args(["--no-reduced"]).reduced is False
    assert serve_lm.parser().parse_args(["--reduced"]).reduced is True


def test_serving_twin_cli(capsys):
    serve_lm.main(["--device", "cpu", "--tokens", "3", "--prompt-len", "8",
                   "--batch", "2"])
    out = capsys.readouterr().out
    assert "2L d=256 vocab=512" in out and "decode : 3 steps" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_lm.main(["--tokens", "1"])
