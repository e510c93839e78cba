"""Runs of the harness on the CPU: the command refuses to run without a
card, and without the program, and prints no result either way; the plain
references agree with themselves; and, at a size a test run holds, every
fault a cell can have makes `correct` come out false, with the timed path
broken underneath and the rest of the run as the command drives it."""
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

import run  # noqa: E402
from benchlib import spec  # noqa: E402

# float32 at this size: the cells' limits are set for bf16 at full width,
# where a tiny bf16 model's rounding would sit near them
TINY_LM = dict(hidden_size=64, num_attention_heads=2, num_key_value_heads=1,
               head_dim=32, num_hidden_layers=2, num_local_experts=4,
               num_experts_per_tok=2, intermediate_size=32, vocab_size=256,
               torch_dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def modules_of_this_run(monkeypatch):
    """The isolation check of an in-process run looks at the modules the
    run loads: other test files of the same worker load JAX on purpose."""
    before = set(sys.modules)
    check = run.isolation.forbidden_loaded
    monkeypatch.setattr(run.isolation, "forbidden_loaded", lambda: check(
        [m for m in list(sys.modules) if m not in before]))


def tiny(cell_name):
    """The cell at a size a CPU test holds: its runner, traffic and limits
    as committed, its widths and counts cut."""
    cell = spec.load_cell(cell_name)
    if cell.runner == "fleet":
        cell.traffic["clients"] = 4
        cell.config.update(samples_per_client=64, test_samples=100)
    else:
        cell.config.update(TINY_LM)
        cell.traffic.update(seq_len=64, len_min=64, len_max=128, len_step=32,
                            check_batches=4)
    return cell


def execute(cell, seed=2200000011):
    return run.execute(cell, seed, 0.3, False, dev="cpu",
                       t_start=time.perf_counter())


def _env(**kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **kw)
    env.pop("PYTHONPATH", None)
    return env


def test_command_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "fleet-cors-n256",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and bench/, a run (here
    told to skip the look for a card) fails before it prints anything."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, 'bench'); import run; "
            "from benchlib import spec; "
            "c = spec.load_cell('fleet-cors-n256'); "
            "print(run.execute(c, 1, 0.1, False, dev='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


@pytest.mark.parametrize("cell", ["fleet-cors-n256", "fleet-il-n256",
                                  "train-granite-cors",
                                  "serve-granite-prefill"])
def test_sound_run_is_correct(cell):
    res = execute(tiny(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


# ---------------------------------------------------------------------------
# faults planted under the timed path
# ---------------------------------------------------------------------------
def _state_unchanged_fleet(mp):
    from repro_torch.core import vec_collab
    make = vec_collab.VectorizedCollabTrainer._make_round_step

    def broken(self):
        step = make(self)

        def same(params, opt, *rest):
            out = step(params, opt, *rest)
            return (params, opt) + tuple(out[2:])
        return same
    mp.setattr(vec_collab.VectorizedCollabTrainer, "_make_round_step", broken)


def _half_batch(mp):
    from repro_torch.core import losses
    ce = losses.ce_loss

    def half(logits, labels):
        n = labels.shape[-1] // 2
        return ce(logits[..., :n, :], labels[..., :n])
    mp.setattr(losses, "ce_loss", half)


def _answer_altered_fleet(mp):
    from repro_torch.core import vec_collab
    make = vec_collab.make_eval_hits

    def broken(spec_):
        hits = make(spec_)
        return lambda P, x, y: hits(P, x, y) + 3
    mp.setattr(vec_collab, "make_eval_hits", broken)


def _state_unchanged_train(mp):
    from repro_torch.launch import train

    def same(params, grads, state, **kw):
        return params, state._replace(step=state.step + 1)
    mp.setattr(train, "adam_update", same)


def _update_scaled_train(mp):
    """Adam's step 1.5 times too long: the update is wrong, the gradient
    and its moments right."""
    from repro_torch.launch import train
    adam = train.adam_update

    def scaled(params, grads, state, **kw):
        return adam(params, grads, state, **dict(kw, lr=1.5 * kw["lr"]))
    mp.setattr(train, "adam_update", scaled)


def _answer_altered_train(mp):
    from repro_torch.core import prototypes
    acc = prototypes.accumulate

    def shifted(state, features, labels):
        return acc(state, features, (labels + 1) % state.num_classes)
    mp.setattr(prototypes, "accumulate", shifted)


def _token_altered_serve(mp):
    from repro_torch import serve_lm
    serve = serve_lm.serve

    def broken(*a, **k):
        out = serve(*a, **k)
        out["logits"] = out["logits"].roll(1, dims=-1)
        return out
    mp.setattr(serve_lm, "serve", broken)


FAULTS = [
    ("fleet-cors-n256", _state_unchanged_fleet),
    ("fleet-cors-n256", _half_batch),
    ("fleet-cors-n256", _answer_altered_fleet),
    ("fleet-il-n256", _state_unchanged_fleet),
    ("fleet-il-n256", _half_batch),
    ("fleet-il-n256", _answer_altered_fleet),
    ("train-granite-cors", _state_unchanged_train),
    ("train-granite-cors", _half_batch),
    ("train-granite-cors", _update_scaled_train),
    ("train-granite-cors", _answer_altered_train),
    ("serve-granite-prefill", _token_altered_serve),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = execute(tiny(cell))
    assert res["correct"] is False, res["checks"]


# ---------------------------------------------------------------------------
# the controls, at the cell's own size on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell,prec", [("fleet-cors-n256", "tf32"),
                                       ("fleet-il-n256", "tf32"),
                                       ("train-granite-cors", "fp8"),
                                       ("serve-granite-prefill", "fp8")])
def test_control_in_lower_precision_is_not_correct(card, cell, prec):
    c = spec.load_cell(cell)
    drv = spec.load_runner(c.runner)
    assert not drv.control(c, 2200000001, "cuda", prec).correct
