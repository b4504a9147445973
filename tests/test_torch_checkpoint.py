"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's contract (`tests/test_fault_tolerance.py`,
`tests/test_checkpoint_resume.py`): atomic and async saves, the newest
complete step, validation before any leaf is rebuilt, and an exact dtype
round trip (bf16 through a 16-bit view, integer, uint8 and bool tensors,
and Python ints as Python ints). Also what only the port needs: each
leaf restored on the device of the example's leaf, and an async save
whose leaves are on the host before the live state moves on in place.
The on-disk layout is the JAX package's; the same arrays saved by both
read back the same bits.
"""
import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import (clone_tree, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import tree_flatten
from repro_torch.core.qasso import QASSOState
from repro_torch.core.quant import QuantParams
from repro_torch.optim.base import AdamState


def assert_tree_bitwise(a, b):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb, f"tree structure differs: {sa} vs {sb}"
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, f"dtype drift: {x.dtype} vs {y.dtype}"
            assert x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)},
            "t": (torch.tensor(7, dtype=torch.int32), torch.zeros(()))}
    save_checkpoint(str(tmp_path), 42, tree)
    assert latest_step(str(tmp_path)) == 42
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 42
    assert_tree_bitwise(tree, restored)


def test_checkpoint_async_and_latest(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    t = save_checkpoint(str(tmp_path), 1, tree, async_write=True)
    t.join()
    save_checkpoint(str(tmp_path), 5, {"w": torch.ones((4, 4)) * 5})
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 5
    assert float(restored["w"][0, 0]) == 5.0


def test_checkpoint_atomicity(tmp_path):
    """A tmp dir without manifest is never considered a checkpoint."""
    os.makedirs(tmp_path / ".tmp_step_9")
    assert latest_step(str(tmp_path)) is None
    assert restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)}) is None
    save_checkpoint(str(tmp_path), 3, {"w": torch.zeros(2)})
    assert latest_step(str(tmp_path)) == 3


def test_restore_preserves_dtypes_roundtrip(tmp_path):
    tree = {"f32": torch.arange(6.0).reshape(2, 3),
            "bf16": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
            "i32": torch.arange(4, dtype=torch.int32),
            "i64": torch.tensor([1, 2 ** 62], dtype=torch.int64),
            "i8": torch.tensor([-3, 7], dtype=torch.int8),
            "u8": torch.tensor([0, 255], dtype=torch.uint8),
            "mask": torch.tensor([True, False])}
    save_checkpoint(str(tmp_path), 1, tree)
    # the example deliberately carries the WRONG dtypes: saved dtypes win
    example = {k: torch.zeros(v.shape) for k, v in tree.items()}
    restored, _ = restore_checkpoint(str(tmp_path), example)
    assert_tree_bitwise(tree, restored)


def test_python_int_leaves_come_back_as_python_ints(tmp_path):
    """QASSO's step and AdamW's count are host ints in the port: their own
    tag, back as ints (not 0-d tensors), inside the NamedTuples and the
    `QuantParams` dataclass of a train state."""
    state = {"qstate": QASSOState(
        step=17, base=AdamState(2 ** 40, {"w": torch.ones(3)},
                                {"w": torch.zeros(3)}),
        redundant={"f": torch.zeros(4)}, keep_mask={"f": torch.ones(4)},
        gamma=torch.zeros(2)),
        "qparams": {"w.wq": QuantParams(torch.tensor(0.1), torch.tensor(1.0),
                                        torch.tensor(1.0))},
        "rng": torch.tensor(12345, dtype=torch.int64), "empty": None}
    save_checkpoint(str(tmp_path), 2, state)
    with open(tmp_path / "step_2" / "manifest.json") as f:
        dtypes = json.load(f)["dtypes"]
    assert dtypes.count("python_int") == 2
    restored, _ = restore_checkpoint(str(tmp_path), state)
    assert_tree_bitwise(state, restored)
    assert type(restored["qstate"].step) is int
    assert type(restored["qstate"].base.count) is int
    assert restored["qstate"].base.count == 2 ** 40
    assert isinstance(restored["qparams"]["w.wq"], QuantParams)
    assert restored["empty"] is None


def test_restore_places_each_leaf_on_the_example_leafs_device(tmp_path):
    """Restore puts every tensor where the example's leaf lives (the meta
    device stands in for a card here), and never moves a CPU leaf."""
    tree = {"w": torch.randn(3, 4), "gamma": torch.zeros(2)}
    save_checkpoint(str(tmp_path), 1, tree)
    example = {"w": torch.empty((3, 4), device="meta"),
               "gamma": torch.zeros(2)}
    restored, _ = restore_checkpoint(str(tmp_path), example)
    assert restored["w"].device.type == "meta"
    assert restored["w"].shape == (3, 4)
    assert restored["gamma"].device.type == "cpu"


def test_async_save_is_immune_to_in_place_updates(tmp_path):
    """The state advances in place (AdamW's moments): an async save must
    hold its own host copy before it returns."""
    live = {"m": torch.zeros(1 << 16), "count": 0}
    want = clone_tree(live)
    t = save_checkpoint(str(tmp_path), 1, live, async_write=True)
    live["m"].add_(1.0)
    t.join()
    restored, _ = restore_checkpoint(str(tmp_path), live)
    assert_tree_bitwise(want, restored)


def test_clone_tree_shares_no_storage():
    tree = {"a": [torch.ones(3), 5], "b": AdamState(1, {"w": torch.ones(2)},
                                                    {"w": torch.ones(2)})}
    c = clone_tree(tree)
    tree["b"].m["w"].mul_(3.0)
    assert float(c["b"].m["w"][0]) == 1.0
    assert_tree_bitwise(c, {"a": [torch.ones(3), 5], "b": AdamState(
        1, {"w": torch.ones(2)}, {"w": torch.ones(2)})})


def test_restore_rejects_structure_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"a": torch.zeros(2),
                                       "b": torch.ones(3)})
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2),
                                           "renamed": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)})
    # a tensor where the saved tree held a Python int is a structure change
    save_checkpoint(str(tmp_path), 4, {"n": 1})
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(str(tmp_path), {"n": torch.zeros(())})


def test_restore_rejects_missing_step(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="no checkpoint for step"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)}, step=99)


def test_restore_refuses_shardings_until_multi_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 14"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(2)},
                           shardings={"a": None})


def test_on_disk_layout_is_the_reference_layout(tmp_path):
    """Same arrays, same files: step_<N>/arrays.npz with keys a{i} in
    sorted-key order and a manifest with the same keys and dtype tags; bf16
    stored as its uint16 bits, as the JAX package stores it."""
    vals = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": np.array([1.5, -2.25], np.float32),
            "c": np.array([3, 4], np.int32)}
    bf = np.array([1.0, -0.5, 3.0], np.float32)
    j_save(str(tmp_path / "ref"), 7, {**{k: jnp.asarray(v)
                                         for k, v in vals.items()},
                                      "d": jnp.asarray(bf, jnp.bfloat16)})
    save_checkpoint(str(tmp_path / "port"), 7, {
        **{k: torch.from_numpy(v) for k, v in vals.items()},
        "d": torch.from_numpy(bf).to(torch.bfloat16)})
    for side in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / side)) == ["step_7"]
        assert sorted(os.listdir(tmp_path / side / "step_7")) == [
            "arrays.npz", "manifest.json"]
    man = {s: json.loads((tmp_path / s / "step_7" / "manifest.json")
                         .read_text()) for s in ("ref", "port")}
    assert set(man["ref"]) == set(man["port"])
    assert man["ref"]["dtypes"] == man["port"]["dtypes"] == [
        "float32", "float32", "int32", "bfloat16"]
    assert man["ref"]["n_arrays"] == man["port"]["n_arrays"] == 4
    ref = np.load(tmp_path / "ref" / "step_7" / "arrays.npz")
    port = np.load(tmp_path / "port" / "step_7" / "arrays.npz")
    assert sorted(ref.files) == sorted(port.files) == ["a0", "a1", "a2",
                                                       "a3"]
    for k in ref.files:
        assert ref[k].dtype == port[k].dtype
        np.testing.assert_array_equal(ref[k], port[k])
