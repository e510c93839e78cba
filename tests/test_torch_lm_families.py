"""Every decoder-only architecture of the port (`repro_torch.models.lm`)
against the reference's (`repro/models/lm.py`), on the CPU, in float32, at
the reference's `reduced()` sizes: GQA (ChatGLM3's rope2d, Qwen2-VL's
embeddings and M-RoPE, DeepSeek-67B), MoE (Granite), MLA with MoE
(DeepSeek-V2-Lite), MLA with compressed queries (MiniCPM3), mamba with the
shared attention block (Zamba2, 4 layers: two applications of the block)
and the xLSTM.

Weights come from the reference's `init_lm` through
`convert.lm_params_from_jax`; inputs from a numpy seed. Floats: max |port -
reference| <= 1e-4 x max(1, max|reference|) for logits and every cache
leaf, float32 products summed in another order; shapes and dtypes exactly.
Decode lives in tests/test_torch_lm_families_decode.py, which shares this
file's models (JAX's compiles pace both files).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, get_shape as jget_shape
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import convert, serve_lm
from repro_torch.configs import ARCHS, get_arch, get_shape
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.tree import leaves

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
S = 8                                      # prompt tokens
FAMILIES = ["chatglm3-6b", "qwen2-vl-7b", "deepseek-67b",
            "granite-moe-1b-a400m", "deepseek-v2-lite-16b", "minicpm3-4b",
            "zamba2-1.2b", "xlstm-125m"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, what=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


def _t(a):
    return torch.from_numpy(np.array(a))


def _reduced(arch, **kw):
    n = 4 if arch == "zamba2-1.2b" else 2
    return get_arch(arch).reduced(num_layers=n, **kw), \
        jget_arch(arch).reduced(num_layers=n, **kw)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg, jcfg = _reduced(arch)
        assert cfg.__dict__ == jcfg.__dict__
        jp = jlm.init_lm(KEY, jcfg)
        _MODELS[arch] = (cfg, jcfg, jp, convert.lm_params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[arch]


def _batch(cfg, n, seed, offset=0):
    """n positions of input (tokens, or embeddings with M-RoPE positions
    whose t, h and w differ) as numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (2, n)).astype(
            np.int32)}
    t = offset + np.arange(n, dtype=np.int32)
    pos = np.stack([np.broadcast_to(t, (2, n)),
                    rng.integers(0, 6, (2, n)),
                    rng.integers(0, 6, (2, n))], -1).astype(np.int32)
    return {"embeddings": rng.standard_normal((2, n, cfg.d_model)).astype(
        np.float32), "positions": pos}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch):
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, S, 1)
    want = jlm.forward(jp, jcfg, _jb(b), mode="prefill")
    got = lm.forward(tp, cfg, _tb(b), mode="prefill")
    _close(got["logits"], want["logits"], "logits")
    _close(got["features"], want["features"], "features")
    assert np.isclose(float(got["aux"]), float(want["aux"]), rtol=TOL,
                      atol=TOL)
    jl = jax.tree.leaves(want["caches"])
    tl = leaves(got["caches"])
    assert len(tl) == len(jl) and len(got["caches"]["shared"]) == len(
        want["caches"]["shared"])
    for i, (a, w) in enumerate(zip(tl, jl)):
        assert str(a.dtype).split(".")[-1] == str(w.dtype), i
        _close(a, w, f"cache leaf {i}")


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serve_specs_match_reference(arch, shape):
    """serve_batch_specs and cache_shapes at the published widths and the
    assigned shapes (the 500k-token window included), as meta tensors,
    against the reference's ShapeDtypeStructs."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert cfg.__dict__ == jcfg.__dict__
    shp, jshp = get_shape(shape), jget_shape(shape)
    assert shp.__dict__ == jshp.__dict__
    specs = serve.serve_batch_specs(cfg, shp)
    jspecs = jserve.serve_batch_specs(jcfg, jshp)
    assert sorted(specs) == sorted(jspecs)
    for k, v in specs.items():
        assert v.is_meta and tuple(v.shape) == jspecs[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jspecs[k].dtype), k
    got, want = serve.cache_shapes(cfg, shp), jserve.cache_shapes(jcfg, jshp)
    tl, jl = leaves(got), jax.tree.leaves(want)
    assert len(tl) == len(jl)
    for a, w in zip(tl, jl):
        assert a.is_meta and tuple(a.shape) == w.shape
        assert str(a.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_and_init_cache_match_the_reference_layout(arch):
    """params_shapes (meta) and init_cache against the reference's, leaf by
    leaf, in the order the reference's checkpoint keys sort them."""
    from repro_torch.checkpoint import io as tio
    cfg, jcfg, jp, tp = _model(arch)
    shapes = serve.params_shapes(cfg)
    got, want = tio._paths(shapes), tio._paths(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].is_meta and got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    c = lm.init_cache(cfg, 3, 16, device="cpu")
    jc = jlm.init_cache(jcfg, 3, 16)
    for a, w in zip(leaves(c), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    assert lm._cache_len(cfg, c) == jlm._cache_len(jcfg, jc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_convert_both_ways(arch):
    """`lm_params_to_numpy` of the converted tree gives back the
    reference's leaves bit for bit: stacked `_e` experts under the layer
    axis, the float32 router and mamba `A_log`, `dt_bias`, `D`, and the
    unstacked `shared` block."""
    _, _, jp, tp = _model(arch)
    back = convert.lm_params_to_numpy(tp)
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    bl = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(jl) == len(bl)
    for path, leaf in jl:
        got = np.asarray(bl[path])
        assert got.dtype == leaf.dtype, path
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "minicpm3-4b",
                                  "zamba2-1.2b"])
def test_train_mode_raises_for_the_new_kinds(arch):
    """MLA, MoE and mamba train: train mode's features, logits and MoE
    balance loss equal the reference's `forward(mode="train")` (gradients
    and train steps in tests/test_torch_family_train.py)."""
    cfg, jcfg, jp, tp = _model(arch)
    b = _batch(cfg, S, 5)
    want = jlm.forward(jp, jcfg, _jb(b), mode="train")
    got = lm.forward(tp, cfg, _tb(b), mode="train")
    _close(got["logits"], want["logits"], "logits")
    _close(got["features"], want["features"], "features")
    assert np.isclose(float(got["aux"]), float(want["aux"]), rtol=TOL,
                      atol=TOL)
    assert got["caches"] is None


def test_registry_holds_every_decoder_only_arch():
    """The registry holds every arch of the reference's, the
    encoder-decoder Whisper-small among them (tests/test_torch_encdec.py)."""
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(FAMILIES + ["tinyllama-1.1b",
                                               "whisper-small"])
    assert sorted(ARCHS) == sorted(JARCHS)
    assert get_arch("whisper-small").__dict__ == \
        jget_arch("whisper-small").__dict__


def test_serving_twin_serves_the_token_models(capsys):
    """The twin's CLI on the reduced MoE model; Qwen2-VL, which takes
    embeddings, raises a clear error."""
    serve_lm.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                   "--tokens", "3", "--prompt-len", "8", "--batch", "2"])
    out = capsys.readouterr().out
    assert "granite-moe-1b-a400m-reduced" in out and "decode : 3 steps" in out
    with pytest.raises(ValueError, match="embeddings"):
        serve_lm.main(["--arch", "qwen2-vl-7b", "--device", "cpu"])
