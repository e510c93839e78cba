"""The LM train step with its clients split over "pod", two gloo CPU ranks
on the mesh (2, 1, 1) over ("pod", "data", "model"), through the dry-run's
`run_one` on the reduced TinyLlama (tests/torch_lm_pod_ranks.py bytes):

  - each rank trains its own client, and the outputs equal the unsharded
    step on the same inputs bit for bit, in cors, fd, fedavg and il (a
    step that indexed the pod-split client axis through DTensor wrote its
    gradients into gathered copies and fed uninitialized memory to Adam);
  - the bytes each rank sends over "pod", counted as the collectives run
    (`roofline.CollectiveBytes`), equal those of the reference's compiled
    step on two host devices: a JAX subprocess lowers it on the same mesh
    and this file reads every all-reduce's tuple shapes itself. Collectives
    of more than one element are compared: cors and fd move the prototype
    sums and counts, C (d' + 1) floats (526,336 B), fedavg every
    parameter, D floats (4,723,712 B), il nothing. The metric scalars are
    reported apart (XLA folds them into the same tuple, DTensor reduces
    each alone); their count agrees too. The reference's own reading,
    `repro.launch.roofline.collective_bytes`, counts only the tuple's first
    shape (524,288 B in cors and fedavg alike); the port sums them all.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.tree import leaves

MODES = ("cors", "fd", "fedavg", "il")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# lowers the reference's step on two host devices, mesh (2, 1, 1), at the
# dry-run's one-step shape for the reduced config (seq 32, 2 rows a client)
JAX_LOWER = r"""
import dataclasses, json, sys
import jax
from repro.configs import get_arch, get_shape
from repro.launch import dryrun, roofline
cfg = get_arch("tinyllama-1.1b").reduced()
shape = dataclasses.replace(get_shape("train_4k"), seq_len=32, global_batch=4)
mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
out = {}
for mode in sys.argv[1:]:
    hlo = dryrun.build_lowered(cfg, shape, mesh, mode=mode,
                               n_clients=2).compile().as_text()
    out[mode] = {"hlo": hlo,
                 "reading": roofline.collective_bytes(hlo)["total"]}
print(json.dumps(out))
"""

_OP = re.compile(r"\s(all-reduce|all-gather|reduce-scatter|all-to-all|"
                 r"collective-permute)(-start)?\(")
_SHAPE = re.compile(r"\b(f32|bf16|s32|f16|pred|s8|u32|s64)\[([0-9,]*)\]")
_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2, "pred": 1,
          "s8": 1, "s64": 8}


def hlo_collectives(hlo):
    """[(kind, [(bytes, elements) of every shape of its result tuple])]: an
    all-reduce's result has its operands' shapes, a tuple for a folded
    one."""
    out = []
    for line in hlo.splitlines():
        m = _OP.search(line)
        if not m or " = " not in line[:m.start() + 1]:
            continue
        res = line[line.index(" = ") + 3:m.start()]
        shapes = []
        for dt, dims in _SHAPE.findall(res):
            n = int(np.prod([int(x) for x in dims.split(",") if x]))
            shapes.append((n * _BYTES[dt], n))
        out.append((m.group(1), shapes))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the reference's HLO by mode), the JAX compile
    and the ranks side by side."""
    d = tmp_path_factory.mktemp("pod_bytes")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2")
    lower = subprocess.Popen([sys.executable, "-c", JAX_LOWER, *MODES],
                             env=jenv, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        ranks = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests", "torch_lm_pod_ranks.py"),
             "bytes", str(d / "out.pt")],
            env=env, capture_output=True, text=True, timeout=300)
        jout, jerr = lower.communicate(timeout=300)
    finally:
        lower.kill()
    assert ranks.returncode == 0, (ranks.stdout[-2000:], ranks.stderr[-4000:])
    assert "POD_BYTES_OK" in ranks.stdout.split()
    assert lower.returncode == 0, jerr[-4000:]
    return (torch.load(d / "out.pt", weights_only=False),
            json.loads(jout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mode", MODES)
def test_pod_step_is_finite_and_equals_unsharded(runs, mode):
    r = runs[0][mode]
    assert r["local_clients"] == 1
    got, want = leaves(r["got"]), leaves(r["want"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if a.is_floating_point():
            assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b), (a.shape, float((a.double() - b.double())
                                                  .abs().max()))


def _one_client_bytes():
    from repro_torch.launch import train
    st = train.init_state_shapes(get_arch("tinyllama-1.1b").reduced(), 1)
    return sum(t.numel() * 4 for t in leaves(st.params))


@pytest.mark.parametrize("mode", MODES)
def test_pod_bytes_equal_the_reference_hlo(runs, mode):
    got, ref = runs[0][mode], runs[1][mode]
    colls = hlo_collectives(ref["hlo"])
    # on (2, 1, 1) only "pod" has two devices: every collective is over it
    ref_payload = sum(b for _, shapes in colls for b, n in shapes if n > 1)
    ref_scalars = sum(1 for _, shapes in colls for _, n in shapes if n == 1)
    port = got["payload"]["pod"]
    assert port["total"] == ref_payload, (port, ref_payload)
    assert port["total"] == port["all-reduce"]
    cfg = get_arch("tinyllama-1.1b").reduced()
    want = {"cors": cfg.vocab_size * (cfg.d_feature + 1) * 4,
            "fd": cfg.vocab_size * (cfg.d_feature + 1) * 4,
            "fedavg": _one_client_bytes(), "il": 0}[mode]
    assert port["total"] == want
    if mode in ("cors", "fd"):
        assert want == 526_336
    if mode == "fedavg":
        assert want == 4_723_712
    # the scalars, apart: one float a metric (four in cors, two elsewhere)
    scalars = got["all"]["pod"]["total"] - port["total"]
    assert scalars == 4 * ref_scalars == 4 * (4 if mode == "cors" else 2)
    # nothing crosses the other (one-rank) axes
    assert all(d["total"] == 0 for a, d in got["all"].items() if a != "pod")


@pytest.mark.parametrize("mode", ("cors", "fedavg"))
def test_the_reference_reading_counts_a_tuples_first_shape(runs, mode):
    """`repro.launch.roofline.collective_bytes` reads the folded all-reduce
    over "pod" as its first shape alone, (512, 256) float32, in cors and
    fedavg alike: the port's counter does not copy that."""
    assert runs[1][mode]["reading"] == 512 * 256 * 4
    assert runs[0][mode]["payload"]["pod"]["total"] > 512 * 256 * 4
