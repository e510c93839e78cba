"""Per-class ring relay, the paper's own buffer layout (section 4, Alg. 1:
"S stores the received observations in the corresponding class buffers");
the port of `repro/relay/per_class.py`.

One ring per class, (C, cap_c, d'), with per-slot validity, owner, birth
stamp and age, and one write pointer per class: a class a client uploads
often cannot evict the other classes' history. The downlink draws m_down
slots per class independently, uniformly over other clients' valid slots in
that class's ring. `age` is clock - stamp for valid slots, recomputed by
`merge_round` (the clock contract of `relay/base.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.relay import base
from repro_torch.relay.base import EMPTY_OWNER, SEED_OWNER
from repro_torch.types import CollabConfig


class PerClassRelayState(NamedTuple):
    """obs (C, cap_c, d') f32; valid (C, cap_c) bool; owner, age, stamp
    (C, cap_c) int32; ptr (C,) int32; global_protos (C, d') f32, valid_g
    (C,) bool, mean_logits (C, C) f32, clock () int32."""
    obs: torch.Tensor
    valid: torch.Tensor
    owner: torch.Tensor
    age: torch.Tensor
    ptr: torch.Tensor
    global_protos: torch.Tensor
    valid_g: torch.Tensor
    mean_logits: torch.Tensor
    stamp: torch.Tensor
    clock: torch.Tensor

    @property
    def capacity(self) -> int:
        """Per-class slot count cap_c."""
        return self.obs.shape[1]


@dataclass(frozen=True)
class PerClassRelay(base.RelayPolicy):
    name: str = "per_class"

    def init_state(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                   capacity: Optional[int] = None, n_clients: int = 2,
                   device=None) -> PerClassRelayState:
        """The flat ring's Algorithm-1 init, per class, drawn with numpy as
        the reference draws it. `capacity` is cap_c; the default is the flat
        ring's slot count."""
        device = resolve_device(device)
        C = ccfg.num_classes
        cap_c = (base.default_capacity(ccfg, n_clients) if capacity is None
                 else capacity)
        if cap_c <= 0:
            raise ValueError("per-class relay capacity must be positive")
        n_seed = min(cap_c, max(1, ccfg.m_down))
        rng = np.random.default_rng(seed)
        protos = rng.normal(size=(C, d_feature)).astype(np.float32) * 0.01
        obs = np.zeros((C, cap_c, d_feature), np.float32)
        obs[:, :n_seed] = rng.normal(
            size=(C, n_seed, d_feature)).astype(np.float32) * 0.01
        valid = np.zeros((C, cap_c), bool)
        valid[:, :n_seed] = True
        owner = np.full((C, cap_c), EMPTY_OWNER, np.int32)
        owner[:, :n_seed] = SEED_OWNER
        t = lambda a: torch.from_numpy(a).to(device)
        zi = lambda s: torch.zeros(s, dtype=torch.int32, device=device)
        return PerClassRelayState(
            obs=t(obs), valid=t(valid), owner=t(owner), age=zi((C, cap_c)),
            ptr=torch.full((C,), n_seed % cap_c, dtype=torch.int32,
                           device=device),
            global_protos=t(protos),
            valid_g=torch.ones(C, dtype=torch.bool, device=device),
            mean_logits=torch.zeros(C, C, device=device),
            stamp=zi((C, cap_c)), clock=zi(()))

    def append(self, state: PerClassRelayState, obs_rows, valid_rows,
               owner_rows, row_mask=None,
               stamp_rows=None) -> PerClassRelayState:
        """Scatter k rows into their class rings: row i's class-c slice goes
        to ring c when valid_rows[i, c] and row_mask[i], and each ring's
        pointer advances by its own write count. Per class the writes land
        in row order, as appending the rows one by one would. At most cap_c
        writes a class.

        Fixed shapes: every (row, class) pair is written, the dropped ones
        to a scratch slot cap_c past each ring's end (`base.scatter_drop`),
        so the write never waits on the card."""
        k, C = valid_rows.shape
        cap_c = state.capacity
        dev = state.obs.device
        w = valid_rows.to(torch.bool)
        if row_mask is not None:
            w = w & row_mask.to(torch.bool)[:, None]                 # (k, C)
        stamps = base.stamps_or_now(state, k, stamp_rows)
        offs = torch.cumsum(w.to(torch.int32), 0) - 1
        slot = torch.where(w, (state.ptr[None, :] + offs) % cap_c,
                           torch.full_like(offs, cap_c)).long()       # (k, C)
        cidx = torch.arange(C, device=dev)[None, :].expand(k, C)
        index = (cidx, slot)
        put = lambda buf, rows: base.scatter_drop(buf, index, rows, dim=1)
        stamp_b = stamps[:, None].expand(k, C)
        return state._replace(
            obs=put(state.obs, obs_rows.float()),
            valid=put(state.valid, torch.ones_like(w)),
            owner=put(state.owner, owner_rows.to(torch.int32)[:, None].expand(k, C)),
            age=put(state.age, state.clock - stamp_b),
            stamp=put(state.stamp, stamp_b),
            ptr=((state.ptr + w.to(torch.int32).sum(0)) % cap_c).to(torch.int32))

    def noise_shape(self, state, m_down):
        return (m_down, state.valid.shape[0], state.capacity)

    def sample_teachers(self, state: PerClassRelayState, client_ids,
                        m_down: int, noise, picks) -> Dict:
        """Per-class uniform sampling over OTHER clients' valid slots, for N
        clients at once. For each class independently: m_down slots from
        that ring's pool (others' valid slots; all valid slots when every one
        is the requester's own; a zero, invalid teacher row for a class
        whose ring is empty), as argmax(noise + where(pool, 0, -inf)) with
        Gumbel noise (N, m_down, C, cap_c): the form the reference's
        `jax.random.categorical(key, logits (C, cap_c), shape=(m_down, C))`
        takes. Teacher obs[n, m, c] = ring_c[idx[n, m, c]]."""
        dev = state.obs.device
        ids = client_ids.to(device=dev, dtype=torch.int32)
        N = ids.shape[0]
        C = state.valid.shape[0]
        usable = state.valid                                          # (C, cap_c)
        others = usable[None] & (state.owner[None] != ids[:, None, None])
        pool = torch.where(others.any(-1, keepdim=True), others, usable[None])
        any_pool = pool.any(-1)                                       # (N, C)
        logits = torch.where(pool, 0.0, float("-inf"))
        logits = torch.where(any_pool[..., None], logits, 0.0)        # (N, C, cap_c)
        idx = (noise.to(torch.float32) + logits[:, None]).argmax(-1)  # (N, M, C)
        obs = state.obs[torch.arange(C, device=dev)[None, None, :], idx]
        obs = torch.where(any_pool[:, None, :, None], obs, 0.0)       # (N, M, C, d')
        return {"global_protos": state.global_protos.expand(N, -1, -1),
                "valid_g": state.valid_g.expand(N, C),
                "obs": obs, "valid_o": any_pool,
                "obs_pick": picks.to(device=dev, dtype=torch.long),
                "mean_logits": state.mean_logits.expand(N, -1, -1)}

    def merge_round(self, state, proto, logit=None):
        """Prototype merge and clock tick; the age of every valid slot
        recomputed from its stamp."""
        state = base.merge_protos(state, proto, logit)
        return state._replace(age=torch.where(
            state.valid, (state.clock - state.stamp).to(torch.int32),
            state.age))

    def evict_owners(self, state, owners):
        """The evicted owners' slots in every class ring become empty; the
        per-class pointers and the clock are untouched."""
        hit = base.owner_hits(state.owner, owners)              # (C, cap_c)
        zero = torch.zeros_like(state.age)
        return state._replace(
            owner=torch.where(hit, EMPTY_OWNER, state.owner),
            valid=state.valid & ~hit,
            age=torch.where(hit, zero, state.age),
            stamp=torch.where(hit, zero, state.stamp))

    def debug_entries(self, state):
        valid = state.valid.cpu().numpy()
        owner, age = state.owner.cpu().numpy(), state.age.cpu().numpy()
        return [{"obs": state.obs[c, s], "class": int(c),
                 "valid": bool(valid[c, s]), "owner": int(owner[c, s]),
                 "age": int(age[c, s])}
                for c, s in zip(*np.nonzero(valid))]
