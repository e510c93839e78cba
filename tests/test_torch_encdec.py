"""Whisper, the port's encoder-decoder (`repro_torch.models.encdec`,
`launch/serve.py`'s encoder-decoder branches, `serve_lm.serve` on a frames
batch), against the reference's (`repro/models/encdec.py`,
`repro/launch/serve.py`), on the CPU, in float32, at the reference's
`reduced()` sizes (2 + 2 layers, d 256, vocabulary 512, 8 frames; 20
frames through `dataclasses.replace`).

Weights come from the reference's `init_encdec` through
`convert.encdec_params_from_jax`; frames and tokens from a numpy seed.
Floats: max |port - reference| <= 1e-4 x max(1, max|reference|) for
features, logits and every cache leaf (float32 products summed in another
order); shapes and dtypes exactly. On the CPU the prefill attention is the
flash kernel's plain version; which calls reach it is counted here through
`attention.prefill_attention`, the count the card's launches must match.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_arch as jget_arch, get_shape as jget_shape
from repro.launch import serve as jserve
from repro.models import encdec as jencdec
from repro_torch import convert, serve_lm
from repro_torch.configs import get_arch, get_shape
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.nn import attention
from repro_torch.tree import leaves

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
B, S = 2, 8                                # batch, prompt tokens


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, what=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _t(a):
    return torch.from_numpy(np.array(a))


_MODELS = {}


def _model(enc_seq=8):
    """(cfg, jcfg, reference params, port params) of the reduced Whisper
    with `enc_seq` frames."""
    if enc_seq not in _MODELS:
        cfg = dataclasses.replace(get_arch("whisper-small").reduced(),
                                  encoder_seq=enc_seq)
        jcfg = dataclasses.replace(jget_arch("whisper-small").reduced(),
                                   encoder_seq=enc_seq)
        assert cfg.__dict__ == jcfg.__dict__
        jp = jencdec.init_encdec(KEY, jcfg)
        _MODELS[enc_seq] = (cfg, jcfg, jp, convert.encdec_params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[enc_seq]


def _inputs(cfg, n, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return frames, toks


class _Spy:
    """Counts the prefill attention's calls (the kernel's on the card) and
    their (Sq, Sk, causal), running the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, causal=True):
        self.calls.append((q.shape[1], k.shape[1], causal))
        return ref.flash_attention(q, k, v, causal=causal)


def test_config_and_sinusoids_match_reference():
    assert get_arch("whisper-small").__dict__ == \
        jget_arch("whisper-small").__dict__
    for T, d in ((1500, 768), (7, 64)):
        _close(encdec._sinusoid(T, d, torch.float32),
               jencdec._sinusoid(T, d, jnp.float32))
    pos = np.random.default_rng(0).integers(0, 448, (3, 5)).astype(np.int32)
    _close(encdec._sinusoid_at(_t(pos), 768, torch.float32),
           jencdec._sinusoid_at(jnp.asarray(pos), 768, jnp.float32))


def test_params_convert_both_ways():
    """`encdec_params_to_numpy` of the converted tree gives back the
    reference's leaves bit for bit, under its paths."""
    cfg, _, jp, tp = _model()
    assert len(tp["enc_layers"]) == cfg.num_encoder_layers
    assert len(tp["dec_layers"]) == cfg.num_layers
    back = convert.encdec_params_to_numpy(tp)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    bl = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(jl) == len(bl)
    for path, leaf in jl:
        np.testing.assert_array_equal(np.asarray(bl[path]), np.asarray(leaf),
                                      err_msg=str(path))


@pytest.mark.parametrize("enc_seq", [8, 20])
def test_encode_matches_reference(enc_seq):
    """Both modes: the prefill attention (the kernel's path) and train
    mode's plain functions."""
    cfg, jcfg, jp, tp = _model(enc_seq)
    frames, _ = _inputs(cfg, S, 1)
    want = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    for mode in ("prefill", "train"):
        _close(encdec.encode(tp, cfg, _t(frames), mode=mode), want, mode)


@pytest.mark.parametrize("enc_seq", [8, 20])
def test_decode_forward_train_and_prefill_match_reference(enc_seq):
    """Features and logits in train and prefill mode, and the prefill's
    self and cross caches, each (L, B, S, G, hd)."""
    cfg, jcfg, jp, tp = _model(enc_seq)
    frames, toks = _inputs(cfg, S, 2)
    jenc = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    tenc = encdec.encode(tp, cfg, _t(frames))
    for mode in ("train", "prefill"):
        want = jencdec.decode_forward(jp, jcfg, jnp.asarray(toks), jenc,
                                      mode=mode)
        got = encdec.decode_forward(tp, cfg, _t(toks), tenc, mode=mode)
        _close(got["features"], want["features"], f"{mode} features")
        _close(got["logits"], want["logits"], f"{mode} logits")
        assert float(got["aux"]) == float(want["aux"]) == 0.0
    _close_caches(got["caches"], want["caches"], "prefill")
    L, G, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    assert got["caches"]["self"][0].shape == (L, B, S, G, hd)
    assert got["caches"]["cross"][0].shape == (L, B, enc_seq, G, hd)


def _prefill_caches(cfg, jcfg, jp, tp, toks, frames):
    """The reference's prefill over toks, its caches as numpy, and the
    port's (as tensors) of the same prefill."""
    jenc = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    jc = jencdec.decode_forward(jp, jcfg, jnp.asarray(toks), jenc,
                                mode="prefill")["caches"]
    return jc, jax.tree.map(lambda a: _t(np.asarray(a)), jc)


def test_decode_appends_as_the_reference():
    """The reference's padded-slot append (tests/test_decode_consistency.py):
    prefill S - 1 tokens, pad the self cache by one slot, decode token S ->
    logits and every cache leaf equal the reference's decode, whose logits
    equal its train-mode forward's at the last position."""
    cfg, jcfg, jp, tp = _model()
    frames, toks = _inputs(cfg, S, 3)
    jc, _ = _prefill_caches(cfg, jcfg, jp, tp, toks[:, :S - 1], frames)
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
    jself = jax.tree.map(pad, jc["self"])
    want = jencdec.decode_forward(jp, jcfg, jnp.asarray(toks[:, S - 1:]),
                                  None, mode="decode", self_cache=jself,
                                  cross_kv=jc["cross"])
    tself = tuple(_t(np.asarray(a)) for a in jself)
    tcross = tuple(_t(np.asarray(a)) for a in jc["cross"])
    got = encdec.decode_forward(tp, cfg, _t(toks[:, S - 1:]), None,
                                mode="decode", self_cache=tself,
                                cross_kv=tcross)
    _close(got["logits"], want["logits"], "logits")
    assert got["caches"]["self"][0] is tself[0]         # written in place
    _close_caches(got["caches"], want["caches"], "decode")
    full = jencdec.decode_forward(
        jp, jcfg, jnp.asarray(toks),
        jencdec.encode(jp, jcfg, jnp.asarray(frames)), mode="train")
    _close(got["logits"][:, 0], full["logits"][:, -1], "decode vs forward")


def test_masked_decode_into_a_grown_cache_equals_the_steady_state():
    """`cache_index`/`masked` (the serving path) into a self cache grown by
    4 slots equals the reference's steady-state decode into a cache padded
    by exactly one, logits and the slots written."""
    cfg, jcfg, jp, tp = _model()
    frames, toks = _inputs(cfg, S, 4)
    jc, tc = _prefill_caches(cfg, jcfg, jp, tp, toks[:, :S - 1], frames)
    jself = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]),
        jc["self"])
    want = jencdec.decode_forward(jp, jcfg, jnp.asarray(toks[:, S - 1:]),
                                  None, mode="decode", self_cache=jself,
                                  cross_kv=jc["cross"])
    grown = encdec.pad_cache_for_decode(tc, 4)
    assert grown["cross"] is tc["cross"]
    assert grown["self"][0].shape[2] == S - 1 + 4
    got = encdec.decode_forward(tp, cfg, _t(toks[:, S - 1:]), None,
                                mode="decode", self_cache=grown["self"],
                                cross_kv=grown["cross"], cache_index=S - 1,
                                masked=True)
    _close(got["logits"], want["logits"], "logits")
    for i, (a, w) in enumerate(zip(got["caches"]["self"],
                                   want["caches"]["self"])):
        _close(a[:, :, :S], w, f"self cache {i}")
        assert not a[:, :, S:].any()


def test_serve_steps_match_reference():
    """launch/serve.py's prefill step (frames and tokens -> last logits and
    caches) and decode step against the reference's."""
    cfg, jcfg, jp, tp = _model()
    frames, toks = _inputs(cfg, S, 5)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    want = jserve.make_prefill_step(jcfg)(jp, jb)
    got = serve.make_prefill_step(cfg)(tp, {"tokens": _t(toks),
                                            "frames": _t(frames)})
    _close(got["logits"], want["logits"], "prefill logits")
    _close_caches(got["caches"], want["caches"], "prefill")
    jcaches = {"self": jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]),
        want["caches"]["self"]), "cross": want["caches"]["cross"]}
    nxt = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 1)
                                            ).astype(np.int32)
    jd = jserve.make_decode_step(jcfg)(jp, {"tokens": jnp.asarray(nxt)},
                                       jcaches)
    td = serve.make_decode_step(cfg)(
        tp, {"tokens": _t(nxt)},
        jax.tree.map(lambda a: _t(np.asarray(a)), jcaches))
    _close(td["logits"], jd["logits"], "decode logits")
    _close_caches(td["caches"], jd["caches"], "decode")


def _close_caches(got, want, what):
    assert sorted(got) == sorted(want) == ["cross", "self"]
    for part in got:
        assert len(got[part]) == len(want[part]) == 2
        for i, (a, w) in enumerate(zip(got[part], want[part])):
            _close(a, w, f"{what} {part} cache {i}")


def test_prefill_and_decode_route_every_attention_to_the_kernel():
    """Outside train mode every attention over a sequence goes to the
    prefill attention (the flash kernel on the card): per layer the
    encoder's (full), the decoder's self (causal) and cross (full, Sq !=
    Sk) in prefill, the cross-attention at Sq = 1 in decode; train mode
    calls it never."""
    cfg, _, _, tp = _model(20)
    frames, toks = _inputs(cfg, S, 7)
    L = cfg.num_layers
    spy = _Spy()
    with attention.prefill_attention(spy), torch.no_grad():
        out = serve.make_prefill_step(cfg)(tp, {"tokens": _t(toks),
                                                "frames": _t(frames)})
        want = [(20, 20, False)] * cfg.num_encoder_layers + \
            [(S, S, True), (S, 20, False)] * L
        assert spy.calls == want
        spy.calls.clear()
        caches = encdec.pad_cache_for_decode(out["caches"], 1)
        serve.make_decode_step(cfg)(tp, {"tokens": _t(toks[:, :1])}, caches,
                                    cache_index=S, masked=True)
        assert spy.calls == [(1, 20, False)] * L
        spy.calls.clear()
        encdec.decode_forward(tp, cfg, _t(toks), encdec.encode(
            tp, cfg, _t(frames), mode="train"), mode="train")
        assert spy.calls == []


def test_serve_lm_serves_a_frames_batch():
    """serve_lm.serve on {"tokens", "frames"}: the prefill's last logits,
    then each greedy step's, equal the train-mode forward over the prompt
    and the generated tokens at positions S - 1 .. S + 3; the CLI raises a
    clear error for Whisper."""
    cfg, _, _, tp = _model()
    frames, toks = _inputs(cfg, S, 8)
    with torch.no_grad():
        r = serve_lm.serve(tp, cfg, {"tokens": _t(toks),
                                     "frames": _t(frames)}, 4)
        assert tuple(r["ids"].shape) == (B, 4)
        assert tuple(r["logits"].shape) == (5, B, cfg.vocab_size)
        seq = torch.cat([_t(toks).long(), r["ids"]], dim=1)
        full = encdec.decode_forward(tp, cfg, seq, encdec.encode(
            tp, cfg, _t(frames)), mode="train")["logits"]
    _close(r["logits"].transpose(0, 1), full[:, S - 1:].numpy())
    assert torch.equal(r["ids"], r["logits"][:4].argmax(-1).T)
    with pytest.raises(ValueError, match="frames"):
        serve_lm.main(["--arch", "whisper-small", "--device", "cpu"])
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_lm.serve(tp, cfg, toks, 2)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_full_width_shapes_equal_eval_shape(shape):
    """params_shapes, serve_batch_specs and cache_shapes of Whisper-small at
    its published widths, as meta tensors (nothing allocated), against the
    reference's under `jax.eval_shape`, leaf by leaf under the checkpoint
    keys."""
    cfg, jcfg = get_arch("whisper-small"), jget_arch("whisper-small")
    shp, jshp = get_shape(shape), jget_shape(shape)
    got = _ref_layout(serve.params_shapes(cfg))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            jio._paths(jserve.params_shapes(jcfg)).items()}
    assert got == want
    assert all(t.is_meta for t in leaves(serve.params_shapes(cfg)))
    specs, jspecs = serve.serve_batch_specs(cfg, shp), \
        jserve.serve_batch_specs(jcfg, jshp)
    assert sorted(specs) == sorted(jspecs)
    for k, v in specs.items():
        assert v.is_meta and tuple(v.shape) == jspecs[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jspecs[k].dtype), k
    if shp.mode == "prefill":
        assert tuple(specs["frames"].shape) == (shp.global_batch, 1500, 768)
    cs, jcs = serve.cache_shapes(cfg, shp), jserve.cache_shapes(jcfg, jshp)
    assert sorted(cs) == sorted(jcs)
    for part in cs:
        for a, w in zip(cs[part], jcs[part]):
            assert a.is_meta and tuple(a.shape) == w.shape, part
            assert str(a.dtype).split(".")[-1] == str(w.dtype), part


def _ref_layout(tree, path=""):
    """{checkpoint key: (shape, dtype)} of the port's encoder-decoder tree
    in the reference's layout: a per-layer list stacked on a layer axis."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _ref_layout(sub, join(name)).items()}
    if isinstance(tree, list):
        return {k: ((len(tree),) + s, dt)
                for k, (s, dt) in _ref_layout(tree[0], path).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
