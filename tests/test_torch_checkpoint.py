"""The port's checkpoint writer (``repro_torch/checkpoint/checkpoint.py``)
against the JAX package's:

  * the four cases of ``tests/test_checkpoint.py`` on the port's writer:
    every step lands via one ``os.replace``; a leaf truncated mid-file is
    skipped by ``latest_step`` (with a warning) and an explicit restore
    names it; manifest damage and a shape mismatch degrade the same way;
    the manager falls back to the newest intact step;
  * cross-reading: a directory the reference's ``save_pytree`` wrote is
    read by the port's ``latest_step``/``load_leaves``/``restore_pytree``
    with equal keys and arrays, and the other way round; a torn step and
    a truncated leaf are skipped by both sides;
  * ``restore_pytree`` gives the template's dtype and device, a bfloat16
    leaf comes back exactly, the writer holds host copies (a tensor
    changed after the save call does not change the checkpoint), and
    ``shardings=`` refuses."""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               CheckpointManager,
                                               latest_step, load_leaves,
                                               restore_pytree, save_pytree)


def _tree(step):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) + step,
            "b": torch.full((5,), float(step), dtype=torch.float32)}


def _nested(step):
    """A tree with every container kind, for the cross-reading cases."""
    rng = np.random.default_rng(step)
    return {"layers": [{"k": rng.standard_normal((2, 3)).astype(np.float32),
                        "ids": np.arange(4, dtype=np.int32) + step}
                       for _ in range(2)],
            "meta": (np.uint8(step), np.frombuffer(b"snap", np.uint8)),
            "a_first": np.float32(step) * np.ones((1,), np.float32)}


def _leaf_files(step_dir):
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return [step_dir / e["file"] for e in manifest["leaves"]]


def test_atomic_save_leaves_no_torn_step(tmp_path):
    save_pytree(_tree(1), tmp_path, step=1, blocking=True)
    assert not list(tmp_path.glob("*.tmp"))
    assert latest_step(tmp_path) == 1
    # a straggler .tmp directory from a crashed save is ignored
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_2.tmp" / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 1


def test_truncated_leaf_skipped_with_fallback(tmp_path, capsys):
    save_pytree(_tree(1), tmp_path, step=1, blocking=True)
    save_pytree(_tree(2), tmp_path, step=2, blocking=True)
    victim = _leaf_files(tmp_path / "step_2")[0]
    raw = victim.read_bytes()
    victim.write_bytes(raw[: len(raw) // 2])
    assert latest_step(tmp_path) == 1
    assert "skipping corrupt step_2" in capsys.readouterr().err
    restored = restore_pytree(_tree(0), tmp_path, step=1)
    assert torch.equal(restored["w"], _tree(1)["w"])
    with pytest.raises(CheckpointCorruptError, match=victim.name):
        restore_pytree(_tree(0), tmp_path, step=2)
    with pytest.raises(CheckpointCorruptError, match=victim.name):
        load_leaves(tmp_path, step=2)


def test_manifest_damage_and_shape_mismatch_detected(tmp_path):
    for s in (1, 2, 3):
        save_pytree(_tree(s), tmp_path, step=s, blocking=True)
    (tmp_path / "step_3" / "manifest.json").write_text("{not json")
    np.save(tmp_path / "step_2" / "swap.npy", np.zeros((2, 2), np.float32))
    os.replace(tmp_path / "step_2" / "swap.npy",
               _leaf_files(tmp_path / "step_2")[0])
    assert latest_step(tmp_path) == 1            # falls past BOTH
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        restore_pytree(_tree(0), tmp_path, step=3)
    with pytest.raises(CheckpointCorruptError, match="mismatches manifest"):
        restore_pytree(_tree(0), tmp_path, step=2)


def test_manager_restore_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in (1, 2):
        mgr.save(_tree(s), step=s, blocking=True)
    victim = _leaf_files(tmp_path / "step_2")[1]
    victim.write_bytes(victim.read_bytes()[:40])
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 1
    assert torch.equal(restored["b"], _tree(1)["b"])
    for f in _leaf_files(tmp_path / "step_1"):
        f.write_bytes(b"")
    assert mgr.restore_latest(_tree(0)) == (None, None)


def test_manager_keeps_the_last_steps_and_saves_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(1, 5):
        mgr.save(_tree(s), step=s)               # writer thread
    mgr.wait()
    # retention runs as a save starts, in the reference's order: the step
    # being written may still be a .tmp then, so an async save can keep
    # one step more than ``keep``
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names in (["step_2", "step_3", "step_4"], ["step_3", "step_4"])
    mgr.save(_tree(5), step=5, blocking=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4",
                                                          "step_5"]
    assert torch.equal(mgr.restore_latest(_tree(0))[0]["w"], _tree(5)["w"])


def _same_leaves(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_reading(tmp_path, writer):
    """Each side reads the directories the other writes: equal keys, leaf
    order, manifests and arrays; a torn step and a truncated leaf are
    skipped by both readers."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for s in (1, 2, 3):
        jck.save_pytree(_nested(s), ref_dir, step=s, blocking=True)
        save_pytree(_nested(s), port_dir, step=s, blocking=True)
    for s in (1, 2, 3):
        man = [json.loads((d / f"step_{s}" / "manifest.json").read_text())
               for d in (ref_dir, port_dir)]
        assert man[0] == man[1]
    d = ref_dir if writer == "reference" else port_dir
    for s in (1, 2, 3):
        _same_leaves(load_leaves(d, s), jck.load_leaves(d, s))
        _same_leaves(load_leaves(d, s), load_leaves(port_dir, s))
    back = restore_pytree(_nested(0), d, 2)
    np.testing.assert_array_equal(back["layers"][1]["k"],
                                  _nested(2)["layers"][1]["k"])
    assert isinstance(back["meta"], tuple) and back["meta"][0] == 2
    jback = jck.restore_pytree(_nested(0), d, 2)
    np.testing.assert_array_equal(np.asarray(jback["layers"][0]["ids"]),
                                  back["layers"][0]["ids"])
    # damage: step 3 torn (a crash before the rename), step 2 truncated
    os.replace(d / "step_3", d / "step_3.tmp")
    victim = _leaf_files(d / "step_2")[0]
    victim.write_bytes(victim.read_bytes()[:60])
    assert latest_step(d) == jck.latest_step(d) == 1


def test_restore_keeps_template_dtype_device_and_host_copies(tmp_path):
    t = {"h": torch.randn(3, 4).to(torch.bfloat16),
         "n": torch.arange(6, dtype=torch.int64), "x": torch.zeros(2)}
    live = t["x"]
    thread = save_pytree(t, tmp_path, step=7, blocking=False)
    live.add_(5.0)                   # after the call: not in the checkpoint
    thread.join()
    back = restore_pytree({"h": torch.zeros(3, 4, dtype=torch.bfloat16),
                           "n": torch.zeros(6, dtype=torch.int64),
                           "x": torch.zeros(2)}, tmp_path, 7)
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"],
                                                             t["h"])
    assert back["n"].dtype == torch.int64 and torch.equal(back["n"], t["n"])
    assert torch.equal(back["x"], torch.zeros(2))
    assert all(v.device == torch.device("cpu") for v in back.values())
    # through shardings: rank 1 of a 1x2 mesh gets its fresh blocks
    from repro_torch.distributed.sharding import Sharding, Spec
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(1, 2, "cpu", rank=1)
    blk = restore_pytree(
        {"h": torch.zeros(3, 2, dtype=torch.bfloat16),
         "n": torch.zeros(3, dtype=torch.int64), "x": torch.zeros(2)},
        tmp_path, 7, shardings={"h": Sharding(mesh, Spec(None, "model")),
                                "n": Sharding(mesh, Spec("model")),
                                "x": Sharding(mesh, Spec(None))})
    assert torch.equal(blk["h"], t["h"][:, 2:]) and blk["h"].is_contiguous()
    assert blk["h"].dtype == torch.bfloat16
    assert torch.equal(blk["n"], t["n"][3:]) and torch.equal(blk["x"],
                                                             back["x"])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree({"h": t["h"], "n": torch.zeros(5), "x": t["x"]},
                       tmp_path, 7)
