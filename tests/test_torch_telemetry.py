"""Fleet telemetry in the port (`repro_torch.obs`): round telemetry in both
engines, trace spans, the JSONL sink and the report, and the relays'
introspection, against the reference; the port of tests/test_telemetry.py.

The fleet is that file's: 4 MLP clients, 192 samples, batch 16, 3 rounds
(mixed fleets: widths 64 and 96 interleaved), the port drawing from the
reference's key schedule (`JaxDraws`). Every round, both of the port's
engines against the reference's sequential engine: the integer leaves
(occupancy, fill, owner diversity, staleness and commit-lag histograms,
pending depth, stale reads) exactly, the float leaves (prototype drift,
per-bucket loss and gradient norm) within 2e-2 (the reference's
`assert_telemetry_match`); what holds is much tighter, within 1e-6 on
every case here (the float leaves reduce the same float32 values in
another order). Records, ledger, ring and weights as
tests/test_torch_async_relay.py holds them.

Tier-1 runs the diagonal of the policy x clocking matrix; the full 3 x 3
matrix carries the registered `slow` marker, which tier-1 deselects.
Functions on seeded inputs (`round_telemetry`, `shard_summary`,
`debug_entries`) are compared with the reference's for every policy and a
sharded state, the commit-lag histogram from a pre-commit pending buffer
with due events.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import assert_telemetry_match
from repro import obs as jobs, relay as jrelay
from repro.core import collab as jcollab, prototypes as jp
from repro.core import vec_collab as jvec
from repro.models import mlp as jmlp
from repro.obs import report as jreport
from repro.relay import events as jevents
from repro.types import CollabConfig as JCollabConfig
from repro.types import FleetConfig as JFleetConfig
from repro.types import TrainConfig as JTrainConfig
from repro_torch import convert, obs as tobs, relay as trelay
from repro_torch.core import collab as tcollab, prototypes as tp
from repro_torch.core import vec_collab as tvec
from repro_torch.obs import report as treport
from repro_torch.relay import events as tevents
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig
from test_torch_async_relay import (J_SPECS, T_SPECS, _data, _kw,  # noqa: F401
                                    delayed_commits, one_torch_thread,
                                    run_three, shared_reference_jits)
from test_torch_collab import JaxDraws

POLICIES = ["flat", "per_class", "staleness"]
# synchronous, event-ordered upload lag, download lag
CLOCKINGS = [(None, None), ("lognormal:2", None), (None, "lognormal:2")]
STREAM = "stream:2,1.5,0.3,7,0"
N_CLIENTS = 4
OBS_TOL = 1e-4


def build(policy="flat", clock=None, dl=None, schedule=None, hetero=False,
          arrivals=None, n_clients=N_CLIENTS, telemetry=True,
          engines=("ref", "seq", "vec"), reference_draws=True, seed=0):
    """The named engines on one MLP fleet with `telemetry`: "ref" (the
    reference's sequential engine), "jvec" (its vectorized one), "seq" and
    "vec" (the port's, drawing from the reference's keys unless
    `reference_draws` is False). -> a list in the order of `engines`."""
    parts, test = _data(n_clients)
    kinds = [i % 2 if hetero else 0 for i in range(n_clients)]
    keys = jax.random.split(jax.random.PRNGKey(seed), n_clients)
    jparams = [jmlp.init_mlp(k, hidden=96 if kind else 64)
               for kind, k in zip(kinds, keys)]
    fleet = dict(policy=policy, participation=schedule, clock=clock,
                 download_clock=dl, arrivals=arrivals)
    jargs = ([J_SPECS[k] for k in kinds], jparams, parts, test,
             JCollabConfig(**_kw("cors")), JTrainConfig(batch_size=16))
    jtel = (jobs.TelemetryConfig(**vars(telemetry))
            if isinstance(telemetry, tobs.TelemetryConfig) else telemetry)

    def port(cls):
        tparams = [convert.params_from_jax(
            {k: np.asarray(v) for k, v in p.items()}, "mlp", device="cpu")
            for p in jparams]
        return cls([T_SPECS[k] for k in kinds], tparams, parts, test,
                   CollabConfig(**_kw("cors")), TrainConfig(batch_size=16),
                   seed=seed, fleet=FleetConfig(**fleet), device="cpu",
                   draws=(JaxDraws(seed, n_clients) if reference_draws
                          else None), telemetry=telemetry)

    make = {"ref": lambda: jcollab.CollabTrainer(
                *jargs, seed=seed, fleet=JFleetConfig(**fleet),
                telemetry=jtel),
            "jvec": lambda: jvec.VectorizedCollabTrainer(
                *jargs, seed=seed, fleet=JFleetConfig(**fleet),
                telemetry=jtel),
            "seq": lambda: port(tcollab.CollabTrainer),
            "vec": lambda: port(tvec.VectorizedCollabTrainer)}
    return [make[e]() for e in engines]


def same_entries(want, got):
    """Two `debug_entries` lists equal: every int key exactly, the
    observations within OBS_TOL."""
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for k in a:
            x = np.asarray(a[k])
            y = b[k].cpu().numpy() if isinstance(b[k], torch.Tensor) \
                else np.asarray(b[k])
            if k == "obs":
                np.testing.assert_allclose(y, x, atol=OBS_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(y, x, err_msg=k)


def run_telemetry(trainers, rounds=3):
    """The three engines side by side (run_three's checks), then every
    round's telemetry of the port's engines against the reference's, and
    the relays' introspection at the end."""
    ref, seq, vec = trainers
    run_three(trainers, rounds)
    for rj, rs, rv in zip(ref.history, seq.history, vec.history):
        for r in (rs, rv):
            assert sorted(r["telemetry"]) == sorted(rj["telemetry"])
            assert_telemetry_match(rj["telemetry"], r["telemetry"])
    want = ref.server.obs_buffer
    same_entries(want, seq.server.debug_entries())
    same_entries(want, vec.policy.debug_entries(vec.relay_state))
    return ref.history


# ---------------------------------------------------------------------------
# both engines against the reference's sequential engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,clocking", list(zip(POLICIES, CLOCKINGS)))
def test_telemetry_engines_match_reference(policy, clocking):
    """The tier-1 diagonal of the policy x clocking matrix."""
    clock, dl = clocking
    records = run_telemetry(build(policy, clock, dl))
    if clock is not None:
        assert sum(sum(r["telemetry"]["commit_hist"][1:])
                   for r in records) == len(delayed_commits(records)) > 0
    if dl is not None:
        assert sum(r["telemetry"]["stale_reads"] for r in records) > 0


@pytest.mark.slow
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("clocking", CLOCKINGS)
def test_telemetry_full_matrix(policy, clocking):
    run_telemetry(build(policy, *clocking))


def test_telemetry_mixed_fleet_under_an_upload_clock():
    """Two buckets under lognormal:2: the bucketed engine computes the
    telemetry in one call after its shared commit, one loss and gradient
    norm entry a bucket."""
    trainers = build("staleness", "lognormal:2", hetero=True)
    assert trainers[2].hetero
    records = run_telemetry(trainers)
    assert delayed_commits(records)
    for t in trainers:
        tel = t.history[-1]["telemetry"]
        assert len(tel["bucket_loss"]) == 2 == len(tel["bucket_grad_norm"])


def test_telemetry_compacted_under_a_download_clock():
    """uniform_k:2, compacted: the step computes the telemetry over the
    full-width metrics and mask; absent clients count in no bucket mean and
    as no stale read, and commit_hist counts every commit."""
    trainers = build("flat", dl="lognormal:2", schedule="uniform_k:2")
    assert trainers[2]._k_active == 2
    records = run_telemetry(trainers)
    for rec in records:
        tel = rec["telemetry"]
        assert sum(tel["commit_hist"]) == len(rec["commits"])
        assert tel["stale_reads"] <= len(rec["participants"])


def test_telemetry_sharded_relay():
    """sharded:flat,4: each shard summarized under vmap and summed; the
    introspection tags every entry with its shard."""
    trainers = build("sharded:flat,4")
    run_telemetry(trainers)
    shards = {e["shard"] for e in trainers[1].server.debug_entries()}
    assert len(shards) > 1
    want = jobs.shard_summary(trainers[0].server.state, N_CLIENTS)
    for st in (trainers[1].server.state, trainers[2].relay_state):
        assert tobs.shard_summary(st, N_CLIENTS) == want


def test_telemetry_streaming_fleet():
    """3 seats of a population of 7 ids on sharded:flat,2, 5 rounds:
    evictions and reclaimed seats; owner diversity by the sorted distinct
    count of external ids."""
    trainers = build("sharded:flat,2", n_clients=3, arrivals=STREAM)
    run_telemetry(trainers, rounds=5)
    seq = trainers[1]
    assert sum(seq._cohort.round(r).evicted.size for r in range(5)) > 0


# ---------------------------------------------------------------------------
# the functions on seeded inputs
# ---------------------------------------------------------------------------
C, D_FEAT = 4, 3
FUNCTION_POLICIES = ["flat", "per_class", "staleness", "sharded:per_class,3"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _seeded_states(spec, rng):
    """(policies, prev states, new states) of both packages after two rounds
    of seeded appends (a row mask, stamps of earlier births, a wrapping
    ring), merges and an eviction; prev is the state before the second.
    The reference's calls are jitted: one compile each instead of one an
    operation."""
    kw = dict(num_classes=C, d_feature=D_FEAT, m_down=2)
    jpol, tpol = jrelay.get_policy(spec), trelay.get_policy(spec)
    jit = {f: jax.jit(getattr(jpol, f)) for f in
           ("append", "reduce_uploads", "merge_round", "evict_owners")
           if getattr(jpol, f) is not None}
    js = jpol.init_state(JCollabConfig(**kw), D_FEAT, seed=0, capacity=5)
    ts = tpol.init_state(CollabConfig(**kw), D_FEAT, seed=0, capacity=5,
                         device="cpu")
    owners = np.array([0, 1, 2, 3, 1, 1000003], np.int32)
    k = owners.size
    prev = None
    for r in range(2):
        prev = (js, ts)
        obs = rng.standard_normal((k, C, D_FEAT)).astype(np.float32)
        valid = rng.random((k, C)) > 0.3
        mask = rng.random(k) > 0.2
        stamps = rng.integers(0, r + 1, k).astype(np.int32)
        js = jit["append"](js, obs, valid, owners, jnp.asarray(mask),
                           jnp.asarray(stamps))
        ts = tpol.append(ts, _t(obs), _t(valid), _t(owners), _t(mask),
                         _t(stamps))
        psum = rng.standard_normal((k, C, D_FEAT)).astype(np.float32)
        pcnt = rng.integers(0, 3, (k, C)).astype(np.float32)
        w = mask.astype(np.float32)
        if tpol.reduce_uploads is not None:
            jproto = jit["reduce_uploads"](
                jnp.asarray(psum), jnp.asarray(pcnt), jnp.asarray(w),
                jnp.asarray(owners))
            tproto = tpol.reduce_uploads(_t(psum), _t(pcnt), _t(w),
                                         _t(owners))
        else:
            s = (psum * w[:, None, None]).sum(0)
            c = (pcnt * w[:, None]).sum(0)
            jproto, tproto = jp.ProtoState(s, c), tp.ProtoState(_t(s), _t(c))
        js = jit["merge_round"](js, jproto)
        ts = tpol.merge_round(ts, tproto)
    evicted = np.array([2, trelay.EMPTY_OWNER], np.int32)
    js = jit["evict_owners"](js, jnp.asarray(evicted))
    ts = tpol.evict_owners(ts, _t(evicted))
    return (jpol, tpol), prev, (js, ts)


def _seeded_pending(rng, n, d_max, round_idx):
    """Both packages' pending buffers with the same seeded live slots,
    births and commit rounds: some due in `round_idx`, some later."""
    live = rng.random((n, d_max)) > 0.3
    birth = rng.integers(round_idx - d_max, round_idx,
                         (n, d_max)).astype(np.int32)
    commit = np.where(rng.random((n, d_max)) > 0.4, round_idx,
                      round_idx + 1).astype(np.int32)
    jpend = jevents.init_pending(n, d_max, 1, C, D_FEAT)._replace(
        live=jnp.asarray(live), birth=jnp.asarray(birth),
        commit=jnp.asarray(commit))
    tpend = tevents.init_pending(n, d_max, 1, C, D_FEAT, device="cpu")._replace(
        live=_t(live), birth=_t(birth), commit=_t(commit))
    return jpend, tpend, int((live & (commit == round_idx)).sum())


@pytest.mark.parametrize("spec", FUNCTION_POLICIES)
def test_round_telemetry_equals_reference(spec):
    """`round_telemetry` of both packages on the same seeded states, mask,
    delays, download delays, bucket parts and pre-commit pending buffer
    (round 5, D_max 7: lags up to the clipped last bin); the same with no
    pending buffer and with host-counted commits; `shard_summary` and
    `debug_entries` of the new state."""
    rng = np.random.default_rng(len(spec))
    (jpol, tpol), (jprev, tprev), (jnew, tnew) = _seeded_states(spec, rng)
    n, r = 6, 5
    mask = rng.random(n) > 0.3
    delays = rng.integers(0, 3, n).astype(np.int32)
    dl = rng.integers(0, 2, n).astype(np.int32)
    ids = [np.arange(0, 4), np.arange(4, 6)]
    loss = rng.standard_normal(n).astype(np.float32) * mask
    gnorm = rng.random(n).astype(np.float32) * mask
    jpend, tpend, n_due = _seeded_pending(rng, n, 7, r)
    assert n_due > 0
    post = tpend._replace(live=tpend.live & (tpend.commit != r))
    jpost = jpend._replace(live=jpend.live & (jpend.commit != r))
    common = lambda to: dict(
        mask=to(mask), loss_parts=tuple(to(loss[i]) for i in ids),
        gnorm_parts=tuple(to(gnorm[i]) for i in ids),
        mask_parts=tuple(to(mask[i]) for i in ids), dl=to(dl))
    cases = [
        (dict(pending=jpost, pending_pre=jpend, round_idx=jnp.int32(r),
              delays=jnp.asarray(delays)),
         dict(pending=post, pending_pre=tpend, round_idx=torch.tensor(
             r, dtype=torch.int32), delays=_t(delays))),
        ({}, {}),
        (dict(commit_hist=jnp.arange(8, dtype=jnp.int32),
              pending_depth=jnp.int32(3)),
         dict(commit_hist=torch.arange(8, dtype=torch.int32),
              pending_depth=torch.tensor(3, dtype=torch.int32)))]
    jtel = jax.jit(jobs.round_telemetry, static_argnums=2)
    for jkw, tkw in cases:
        want = jobs.to_record(jtel(jprev, jnew, n, **common(jnp.asarray),
                                   **jkw))
        tel = tobs.round_telemetry(tprev, tnew, n, **common(_t), **tkw)
        assert [t.dtype for t in tel] == [torch.int32] * 7 + [torch.float32] * 3
        got = tobs.to_record(tel)
        assert_telemetry_match(want, got, float_tol=1e-6)
        assert json.loads(json.dumps(got)) == got
    lagged = tobs.to_record(tobs.round_telemetry(
        tprev, tnew, n, **common(_t), **cases[0][1]))["commit_hist"]
    assert sum(lagged) == int((mask & (delays == 0)).sum()) + n_due
    assert lagged[-1] > 0
    assert tobs.shard_summary(tnew) == jobs.shard_summary(jnew)
    same_entries(jpol.debug_entries(jnew), tpol.debug_entries(tnew))


def test_histograms_do_not_use_bincount(monkeypatch):
    """On CUDA `torch.bincount` reads its input's maximum to size its
    output, a host sync inside the step; the histograms are fixed-length
    one-hot sums instead."""
    def refuse(*a, **k):
        raise AssertionError("bincount called")
    monkeypatch.setattr(torch, "bincount", refuse)
    pol = trelay.get_policy("sharded:staleness,2")
    prev = pol.init_state(CollabConfig(num_classes=C, d_feature=D_FEAT),
                          D_FEAT, capacity=5, device="cpu")
    new = pol.append(prev, torch.ones(2, C, D_FEAT), torch.ones(2, C).bool(),
                     _t(np.array([0, 1], np.int32)))
    tel = tobs.round_telemetry(prev, new, 2, mask=_t([True, False]),
                               loss_parts=(_t([1.0, 0.0]),),
                               gnorm_parts=(_t([2.0, 0.0]),),
                               mask_parts=(_t([True, False]),))
    assert tel.stale_hist.shape == tel.commit_hist.shape == (tobs.STALE_BINS,)


# ---------------------------------------------------------------------------
# telemetry off, and the argument
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clock,dl,n_out", [(None, None, 4),
                                            ("lognormal:2", None, 5),
                                            (None, "lognormal:2", 5),
                                            ("lognormal:2", "lognormal:2", 6)])
def test_telemetry_off_leaves_the_step_and_the_records_as_they_were(
        clock, dl, n_out):
    """Off: no `telemetry` key, the vec step's output tuple has its old
    length (on: one more, the RoundTelemetry last). On changes nothing
    else: records, ring and weights of both engines bit-equal to a run with
    it off."""
    runs = {}
    for tel in (None, True):
        seq, vec = build(clock=clock, dl=dl, telemetry=tel,
                         engines=("seq", "vec"), reference_draws=False)
        outs = []
        step = vec._round_step
        vec._round_step = lambda *a: outs.append(step(*a)) or outs[-1]
        for _ in range(2):
            for t in (seq, vec):
                t.run_round()
        assert [len(o) for o in outs] == [n_out + (tel is not None)] * 2
        assert all(isinstance(o[-1], tobs.RoundTelemetry) == (tel is not None)
                   for o in outs)
        runs[tel] = (seq, vec)
    for off, on in zip(runs[None], runs[True]):
        for a, b in zip(off.history, on.history):
            assert "telemetry" not in a and "telemetry" in b
            assert a == {k: v for k, v in b.items() if k != "telemetry"}
        st = lambda t: t.server.state if hasattr(t, "server") \
            else t.relay_state
        for f, x in zip(st(off)._fields, st(off)):
            assert torch.equal(x, getattr(st(on), f)), f
        for i in range(N_CLIENTS):
            wa = off.clients[i].params if hasattr(off, "clients") \
                else off.client_params(i)
            wb = on.clients[i].params if hasattr(on, "clients") \
                else on.client_params(i)
            for k in wa:
                assert torch.equal(wa[k], wb[k]), (i, k)


@pytest.mark.parametrize("bad", ["yes", 1, {"metrics": True}])
def test_telemetry_argument_is_validated(bad):
    for engine in ("seq", "vec"):
        with pytest.raises(TypeError):
            build(telemetry=bad, engines=(engine,), reference_draws=False)
    assert tobs.resolve(None) is None and tobs.resolve(False) is None
    assert tobs.resolve(True) == tobs.TelemetryConfig()


# ---------------------------------------------------------------------------
# sink, report, trace
# ---------------------------------------------------------------------------
def test_jsonl_sink_and_report_equal_the_reference(tmp_path):
    """The JSONL reads back equal to the trainer's history; `render` of it
    equals the reference's `render` of the same records, also with
    --last; the CLI renders the file; without metrics the records carry no
    telemetry and both renders fall back alike."""
    path = tmp_path / "run.jsonl"
    seq, vec = build(clock="lognormal:2", engines=("seq", "vec"),
                     telemetry=tobs.TelemetryConfig(jsonl=str(path)))
    vec.run(3)
    records = tobs.read_jsonl(str(path))
    assert records == json.loads(json.dumps(vec.history))
    assert records == jobs.read_jsonl(str(path))
    for last in (0, 2):
        text = treport.render(records, last=last)
        assert text == jreport.render(records, last=last)
    assert "commit-lag histogram" in text and "comm: up" in text
    assert treport.main([str(path), "--last", "2"]) == 0
    assert treport.render([]) == jreport.render([])

    path2 = tmp_path / "plain.jsonl"
    seq = build(telemetry=tobs.TelemetryConfig(metrics=False,
                                               jsonl=str(path2)),
                engines=("seq",), reference_draws=False)[0]
    seq.run(2)
    records = tobs.read_jsonl(str(path2))
    assert len(records) == 2 and "telemetry" not in records[0]
    text = treport.render(records)
    assert text == jreport.render(records)
    assert "commit-lag histogram" not in text


def _span_names(path):
    doc = json.loads(path.read_text())
    for e in doc["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and "ts" in e
    return [(e["name"], e.get("args")) for e in doc["traceEvents"]]


@pytest.mark.parametrize("engines,fleet", [
    (("ref", "seq"), dict(clock="lognormal:2")),
    (("ref", "seq"), dict(policy="sharded:flat,2", n_clients=3,
                          arrivals=STREAM)),
    (("jvec", "vec"), dict(dl="lognormal:2", hetero=True)),
    (("jvec", "vec"), dict(policy="sharded:flat,2", n_clients=3,
                           arrivals=STREAM))])
def test_trace_spans_equal_the_reference(tmp_path, engines, fleet):
    """The Chrome trace of each of the port's engines names the same spans,
    in the same order and with the same args, as the reference's engine of
    the same kind on the same fleet (profile mode on: the spans wait on
    their outputs, nothing on the CPU); a streaming fleet's rounds with
    evictions open an `evict` span."""
    names = []
    for e in engines:
        path = tmp_path / f"{e}.json"
        t = build(**fleet, engines=(e,), reference_draws=False,
                  telemetry=tobs.TelemetryConfig(trace=str(path),
                                                 profile=True))[0]
        t.run(4 if "arrivals" in fleet else 2)
        names.append(_span_names(path))
    assert names[1] == names[0]
    if "arrivals" in fleet:
        assert ("evict", {"round": 3}) in names[1]


def test_spans_are_profiler_ranges():
    """A span is a `torch.profiler.record_function` range: a profile of a
    traced round holds the engine's span names."""
    from torch.profiler import ProfilerActivity, profile
    vec = build(engines=("vec",), reference_draws=False,
                telemetry=tobs.TelemetryConfig(profile=True))[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vec.run_round()
    keys = {e.key for e in prof.key_averages()}
    assert {"round_step", "eval"} <= keys
    assert [e["name"] for e in vec._obs.tracer.events] == ["round_step",
                                                           "eval"]
