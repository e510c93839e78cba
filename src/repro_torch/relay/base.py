"""The relay-policy contract and the pieces every policy shares; the port of
`repro/relay/base.py`.

The paper's server is a relay: it never touches model weights, so its only
design freedom is how observations are retained and how a teacher is
sampled for a downloading client. A `RelayPolicy` packages those two choices
behind these functions; the engines do the rest.

  init_state(ccfg, d_feature, seed, capacity, n_clients, device) -> state
      Seeds the buffers and the random prototypes (Algorithm 1), drawn with
      numpy exactly as the reference does.
  append(state, obs_rows, valid_rows, owner_rows, row_mask=None,
         stamp_rows=None) -> state
      Writes k observation rows. Rows with `row_mask` False are dropped
      without consuming a slot; `stamp_rows` are the rows' birth clocks
      (None: born now). Fixed shapes throughout, so the write never waits
      on the card.
  sample_teachers(state, ids, m_down, noise, picks) -> teacher dict
      The downlink for N clients at once, every entry with a leading client
      axis and the keys `TEACHER_KEYS`. The reference draws from a
      `jax.random` key; the port takes the draws as arguments: `noise`
      (N, *noise_shape(state, m_down)) standard Gumbel noise and `picks`
      (N,) the observation each client's loss uses. A draw made from the
      reference's own key therefore reproduces its indices.
  noise_shape(state, m_down) -> tuple
      One client's Gumbel noise shape: each policy draws differently.
  merge_round(state, proto, logit=None) -> state
      The end-of-round merge of the clients' per-class sums (and, in fd
      mode, per-class logit sums), the clock tick, and any per-slot
      bookkeeping (the ages of per_class and staleness).

Every state is a NamedTuple of tensors on one device and carries the shared
prototype fields (`global_protos`, `valid_g`, `mean_logits`), a logical
clock (merges performed) and a birth `stamp` per slot; functions return new
states and leave their inputs untouched. Engines call `append` and then
`merge_round`, once a round.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import prototypes
from repro_torch.types import CollabConfig

# Ring-slot owner sentinels. Real clients are >= 0.
SEED_OWNER = -1      # server-seeded random observation (paper Alg. 1 init)
EMPTY_OWNER = -2     # slot never written

# The teacher dict's keys (what `core.client.loss_fn` consumes); every
# policy returns exactly these, with the same shapes and dtypes.
TEACHER_KEYS = ("global_protos", "valid_g", "obs", "valid_o", "obs_pick",
                "mean_logits")


def default_capacity(ccfg: CollabConfig, n_clients: int = 2) -> int:
    """32 . N . M_up live observations."""
    return 32 * max(1, n_clients) * max(1, ccfg.m_up)


def merge_protos(state, proto: prototypes.ProtoState,
                 logit: Optional[prototypes.ProtoState] = None):
    """Per-round recompute of t-bar^c (Alg. 1), of the mean logits when
    `logit` is given (fd), and the server logical-clock tick (one tick per
    merge)."""
    state = state._replace(global_protos=prototypes.means(proto),
                           valid_g=proto.count > 0, clock=state.clock + 1)
    if logit is not None:
        state = state._replace(mean_logits=prototypes.means(logit))
    return state


def stamps_or_now(state, k: int, stamp_rows=None):
    """Rows' birth clocks: `stamp_rows`, or the current clock for all k
    rows (the synchronous case). (k,) int32."""
    if stamp_rows is None:
        return state.clock.to(torch.int32).expand(k).clone()
    return stamp_rows.to(torch.int32)


def ring_indices(ptr, k: int, cap: int, row_mask=None):
    """Ring write positions for k rows, of which only `row_mask` are real
    (None = all). Masked-out rows get index `cap` (out of range: the append
    drops them) and consume no slot. Returns (idx (k,) int32, new_ptr ()
    int32)."""
    if row_mask is None:
        idx = (ptr + torch.arange(k, dtype=torch.int32, device=ptr.device)) % cap
        return idx.to(torch.int32), ((ptr + k) % cap).to(torch.int32)
    w = row_mask.to(torch.int32)
    offs = torch.cumsum(w, 0) - 1                 # slot offset per real row
    idx = torch.where(row_mask, (ptr + offs) % cap,
                      torch.full_like(offs, cap)).to(torch.int32)
    return idx, ((ptr + w.sum()) % cap).to(torch.int32)


def scatter_drop(buf, index, rows, dim: int = 0):
    """`buf` with `rows` written at `index` along `dim`, where index ==
    buf.shape[dim] drops the row: the reference's `.at[].set(mode="drop")`
    with fixed shapes. The rows land in a copy of `buf` with one scratch
    slot past its end along `dim`, and the copy without that slot is
    returned. `index` is a tuple of index tensors for the leading dims up
    to and including `dim`."""
    n = buf.shape[dim]
    pad = buf.narrow(dim, 0, 1)
    out = torch.cat([buf, pad], dim)
    out[index] = rows.to(buf.dtype)
    return out.narrow(dim, 0, n)


def gumbel(shape, generator: Optional[torch.Generator] = None):
    """Standard Gumbel noise of `shape`, f32 on the CPU."""
    u = torch.rand(*shape, generator=generator)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


class RelayPolicy:
    """Abstract base; see the module docstring for the contract."""
    name: str = "abstract"

    def init_state(self, ccfg: CollabConfig, d_feature: int, seed: int = 0,
                   capacity: Optional[int] = None, n_clients: int = 2,
                   device=None):
        raise NotImplementedError

    def append(self, state, obs_rows, valid_rows, owner_rows, row_mask=None,
               stamp_rows=None):
        raise NotImplementedError

    def noise_shape(self, state, m_down: int) -> tuple:
        raise NotImplementedError

    def sample_teachers(self, state, client_ids, m_down: int, noise,
                        picks) -> Dict:
        raise NotImplementedError

    def merge_round(self, state, proto, logit=None):
        raise NotImplementedError

    def sample_teacher(self, state, client_id: int, m_down: int, noise,
                       obs_pick: int = 0) -> Dict:
        """One client's teacher: `sample_teachers` on a fleet of one, noise
        of `noise_shape(state, m_down)` and `obs_pick` an int."""
        dev = state.obs.device
        t = self.sample_teachers(
            state, torch.full((1,), int(client_id), device=dev), m_down,
            noise.to(dev)[None], torch.zeros(1, device=dev))
        t = {k: v[0] for k, v in t.items()}
        t["obs_pick"] = int(obs_pick)
        return t
