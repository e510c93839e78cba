"""Decode of every decoder-only architecture of the port against the
reference's, on the CPU, in float32, at the reduced sizes of
tests/test_torch_lm_families.py (whose models, inputs and tolerance it
shares): masked incremental decode into a grown cache, logits and every
cache leaf within 1e-4 x max(1, max|reference|) after each step. The
port's own decode-against-prefill property, with MoE at a capacity factor
of num_experts (as the reference's tests/test_decode_consistency.py sets
it: prefill and decode then route alike), is held to the same bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm
from repro_torch.tree import leaves, tree_map
from test_torch_lm_families import (FAMILIES, S, _batch, _close, _jb, _model,
                                    _reduced, _t, _tb,
                                    one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("arch", FAMILIES)
def test_masked_decode_matches_reference(arch):
    """Two incremental decode steps (cache_index S, S + 1, masked) into the
    reference's prefill caches grown by 4 slots: logits and every cache
    leaf after each step."""
    cfg, jcfg, jp, tp = _model(arch)
    jc = jlm.forward(jp, jcfg, _jb(_batch(cfg, S, 2)), mode="prefill")[
        "caches"]
    for _ in range(4):
        jc = jlm.pad_cache_for_decode(jcfg, jc)
    tc = tree_map(_t, jax.tree.map(np.asarray, jc))
    jdecode = jax.jit(lambda b, c, i: jlm.decode_step(
        jp, jcfg, b, c, cache_index=i, masked=True))     # one compile, 2 steps
    for i in range(2):
        b = _batch(cfg, 1, 3 + i, offset=S + i)
        want = jdecode(_jb(b), jc, jnp.asarray(S + i, jnp.int32))
        got = lm.decode_step(tp, cfg, _tb(b), tc, cache_index=S + i,
                             masked=True)
        jc, tc = want["caches"], got["caches"]
        _close(got["logits"], want["logits"], f"step {i} logits")
        for j, (a, w) in enumerate(zip(leaves(tc), jax.tree.leaves(jc))):
            _close(a, w, f"step {i} cache leaf {j}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_continues_the_prefill(arch):
    """The port alone: prefill of S - 1 positions, the caches padded by one
    slot, one decode step -> the prefill of S at its last position."""
    cfg, _ = _reduced(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = _tb(_batch(cfg, S, 4))
    full = lm.forward(p, cfg, b, mode="prefill")["logits"][:, -1]
    pre = lm.forward(p, cfg, {k: v[:, :S - 1] for k, v in b.items()},
                     mode="prefill")
    dec = lm.decode_step(p, cfg, {k: v[:, S - 1:] for k, v in b.items()},
                         lm.pad_cache_for_decode(cfg, pre["caches"]))
    _close(dec["logits"][:, 0], full.numpy())


def test_serve_decodes_an_embeddings_batch_as_its_prefill():
    """serve_lm.serve on Qwen2-VL's embeddings and M-RoPE positions, each
    step's batch from `next_batch`: the prefill's last logits, then each
    step's, equal the prefill of all S + 3 positions at S - 1 .. S + 2; no
    tokens come back."""
    from repro_torch import serve_lm
    cfg, _ = _reduced("qwen2-vl-7b")
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = _tb(_batch(cfg, S + 3, 6))
    full = lm.forward(p, cfg, b, mode="prefill")["logits"]
    seen = []

    def next_batch(i, logits):
        seen.append(i)
        return {k: v[:, S + i:S + i + 1] for k, v in b.items()}

    r = serve_lm.serve(p, cfg, {k: v[:, :S] for k, v in b.items()}, 3,
                       next_batch)
    assert seen == [0, 1, 2] and tuple(r["ids"].shape) == (2, 0)
    _close(r["logits"].transpose(0, 1), full[:, S - 1:].numpy())
