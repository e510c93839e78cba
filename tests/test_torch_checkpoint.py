"""Checkpoints of the port (`repro_torch.checkpoint`) against the reference's
`repro.checkpoint`: the same .npz and sidecar layout and leaf keys, so each
package loads the other's files (image-model parameters through `convert`,
the reference's convolutions being HWIO); and the twin's `--telemetry-out`
and `--out` on the CPU. Loads are exact: the same float32 and int bits.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.models import cnn as jcnn
from repro_torch import convert, obs as tobs
from repro_torch.checkpoint import io as tio
from repro_torch.collab_image_classification import main as twin_main
from repro_torch.obs import report as treport


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 2, generator=g),
            "layers": [{"b": torch.arange(4, dtype=torch.int32),
                        "s": torch.randn((), generator=g)},
                       (torch.randn(2, 2, 1, generator=g),
                        torch.ones(5, dtype=torch.int32))],
            "empty": None, "flag": torch.zeros(1, dtype=torch.bool)}


def _jax_like(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def test_round_trip_of_nested_dicts_lists_and_tuples(tmp_path):
    tree = _tree()
    tio.save_pytree(str(tmp_path / "ck.npz"), tree, step=11)
    template = jax.tree.map(torch.zeros_like, tree,
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    got = tio.load_pytree(str(tmp_path / "ck"), template)
    assert isinstance(got["layers"][1], tuple) and got["empty"] is None
    flat_a, flat_b = tio._paths(tree), tio._paths(got)
    assert list(flat_a) == list(flat_b)
    for k in flat_a:
        assert flat_b[k].dtype == flat_a[k].dtype, k
        assert torch.equal(flat_b[k], flat_a[k]), k
    meta = json.loads((tmp_path / "ck.json").read_text())
    assert meta["step"] == 11 and meta["keys"] == sorted(flat_a)
    assert meta["shapes"]["layers/1/0"] == [2, 2, 1]
    assert meta["dtypes"]["layers/0/b"] == "int32"


def test_load_lands_on_the_template_dtype_and_device(tmp_path):
    tio.save_pytree(str(tmp_path / "ck"), {"a": torch.full((2,), 1.5),
                                           "n": torch.arange(3)})
    got = tio.load_pytree(str(tmp_path / "ck"), {
        "a": torch.zeros(2, dtype=torch.float64),
        "n": torch.zeros(3, dtype=torch.int32, device="cpu")})
    assert got["a"].dtype == torch.float64 and got["n"].dtype == torch.int32
    assert got["n"].device == torch.device("cpu")
    assert got["a"].tolist() == [1.5, 1.5] and got["n"].tolist() == [0, 1, 2]


def test_keys_equal_the_reference_paths(tmp_path):
    tree = _tree()
    assert list(tio._paths(tree)) == list(jio._paths(_jax_like(tree)))
    tio.save_pytree(str(tmp_path / "port.npz"), tree, step=2)
    jio.save_pytree(str(tmp_path / "ref.npz"), _jax_like(tree), step=2)
    a = json.loads((tmp_path / "port.json").read_text())
    b = json.loads((tmp_path / "ref.json").read_text())
    assert a == b


def test_cross_load_through_convert(tmp_path):
    """A LeNet the port wrote (reference layout, `params_to_numpy`) loads in
    the reference onto its own template; one the reference wrote loads in
    the port onto a reference-layout template and converts back with
    `params_from_jax`; both bit-equal."""
    jparams = jcnn.init_cnn(jax.random.PRNGKey(3))
    tparams = convert.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cnn", device="cpu")
    tio.save_pytree(str(tmp_path / "port.npz"),
                    convert.params_to_numpy(tparams, "cnn"), step=1)
    loaded = jio.load_pytree(str(tmp_path / "port.npz"), jparams)
    for k in jparams:
        np.testing.assert_array_equal(np.asarray(loaded[k]),
                                      np.asarray(jparams[k]), err_msg=k)

    jio.save_pytree(str(tmp_path / "ref.npz"), jparams, step=1)
    template = {k: torch.zeros(v.shape) for k, v in jparams.items()}
    got = tio.load_pytree(str(tmp_path / "ref.npz"), template)
    back = convert.params_from_jax({k: v.numpy() for k, v in got.items()},
                                   "cnn", device="cpu")
    for k in tparams:
        assert torch.equal(back[k], tparams[k]), k


def test_shape_mismatch_is_a_value_error(tmp_path):
    tio.save_pytree(str(tmp_path / "ck.npz"), {"w": torch.ones(3, 2)})
    with pytest.raises(ValueError, match="stored shape"):
        tio.load_pytree(str(tmp_path / "ck.npz"), {"w": torch.ones(2, 3)})


def test_a_npz_inside_the_path_is_not_the_extension(tmp_path):
    run = tmp_path / "sweep.npz_v2"
    tio.save_pytree(str(run / "client0.npz"), {"w": torch.ones(2)})
    tio.save_pytree(str(run / "client1"), {"w": torch.zeros(2)})
    assert sorted(p.name for p in run.iterdir()) == [
        "client0.json", "client0.npz", "client1.json", "client1.npz"]
    assert tio._base("a/sweep.npz_v2/ck.npz") == "a/sweep.npz_v2/ck"
    assert tio._base("a/sweep.npz_v2/ck") == "a/sweep.npz_v2/ck"
    got = tio.load_pytree(str(run / "client1.npz"), {"w": torch.ones(2)})
    assert torch.equal(got["w"], torch.zeros(2))


def test_twin_writes_telemetry_and_checkpoints(tmp_path, capsys):
    """One round of the twin on the CPU, 2 LeNet clients under a download
    clock: the JSONL (one record, telemetry included) renders,
    the fleet-health lines print, and every client's checkpoint loads in
    the reference onto a reference LeNet's template."""
    jsonl, out = tmp_path / "run.jsonl", tmp_path / "ck"
    twin_main(["--rounds", "1", "--clients", "2", "--device", "cpu",
               "--download-clock", "homogeneous:1",
               "--telemetry-out", str(jsonl), "--out", str(out)])
    text = capsys.readouterr().out
    assert "download lag: 2 client-rounds" in text
    assert f"telemetry: {jsonl}" in text
    records = tobs.read_jsonl(str(jsonl))
    assert len(records) == 1 and records[0]["telemetry"]["stale_reads"] == 2
    assert "run report: 1 rounds" in treport.render(records)
    template = jcnn.init_cnn(jax.random.PRNGKey(0))
    for i in range(2):
        got = jio.load_pytree(str(out / f"client{i}.npz"), template)
        assert json.loads((out / f"client{i}.json").read_text())["step"] == 1
        assert all(np.isfinite(np.asarray(v)).all() for v in got.values())
