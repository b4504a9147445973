"""Checkpointing of a train state tree, port of `repro.checkpoint`.

Format (the JAX package's): <dir>/step_<N>/arrays.npz holds the leaves as
host numpy arrays under `a{i}`, in flattening order; <dir>/step_<N>/
manifest.json holds the step, the tree's structure string, the leaf
count, a dtype tag per leaf and free-form meta. A save writes into
`.tmp_step_<N>` and renames it once complete, so a crash mid-write never
leaves a directory that `latest_step` would take for a checkpoint.
`async_write=True` copies every leaf to the host first (the state advances
in place: QASSO's and AdamW's moments) and only writes in a thread.

A tree is nested dicts (sorted keys, as JAX flattens them), lists,
tuples, NamedTuples, dataclasses (`QuantParams`) and None (no leaf), with
tensors and Python ints at the leaves. Dtypes round-trip exactly: bf16 as
a 16-bit view under the tag "bfloat16", integer and bool tensors as
saved, and Python ints (QASSO's step, AdamW's count) under the tag
"python_int", back as Python ints. Restore never casts to the example's
dtype and places each tensor on the device of the example's matching
leaf (QASSO keeps `gamma` on the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

PYTHON_INT = "python_int"
BF16 = "bfloat16"


def _children(tree) -> tuple[str, list] | None:
    """(structure prefix, children in flattening order) of a node, None
    for a leaf."""
    if tree is None:
        return "None", []
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict" + repr(keys), [tree[k] for k in keys]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + repr(tree._fields), list(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return (type(tree).__name__ + repr(names),
                [getattr(tree, n) for n in names])
    return None


def _leaf_kind(x) -> str:
    if isinstance(x, torch.Tensor):
        return "*"
    if isinstance(x, int) and not isinstance(x, bool):
        return "int"
    raise TypeError(f"checkpoint leaf of type {type(x).__name__}: the tree "
                    f"holds tensors and Python ints at its leaves")


def tree_flatten(tree) -> tuple[list, str]:
    """(leaves, structure string) of `tree`."""
    leaves = []

    def walk(node) -> str:
        node_kind = _children(node)
        if node_kind is None:
            leaves.append(node)
            return _leaf_kind(node)
        prefix, kids = node_kind
        return prefix + "(" + ",".join(walk(k) for k in kids) + ")"

    return leaves, walk(tree)


def tree_map(fn, tree):
    """`tree` with every leaf replaced by fn(leaf), containers rebuilt."""
    node_kind = _children(tree)
    if node_kind is None:
        return fn(tree)
    _, kids = node_kind
    new = [tree_map(fn, k) for k in kids]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    if isinstance(tree, (list, tuple)):
        return type(tree)(new)
    names = [f.name for f in dataclasses.fields(tree)]
    return dataclasses.replace(tree, **dict(zip(names, new)))


def clone_tree(tree):
    """A copy of `tree` whose tensors share no storage with it."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array (a copy, never a view of the live tensor)
    and its dtype tag."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, np.int64), PYTHON_INT
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, tag: str, example):
    if tag == PYTHON_INT:
        return int(a)
    if tag == BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(example.device) if isinstance(example, torch.Tensor) else t


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: Optional[dict] = None, async_write: bool = False):
    """Write `tree` as step `step` under `directory`. With `async_write`
    the leaves are on the host when this returns, and the returned thread
    writes them."""
    flat, structure = tree_flatten(tree)
    host, dtypes = zip(*[_to_host(x) for x in flat]) if flat else ((), ())

    def write():
        tmp = os.path.join(directory, f".tmp_step_{step}")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        manifest = {"step": step, "treedef": structure,
                    "n_arrays": len(host), "dtypes": list(dtypes),
                    "meta": meta or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    """The newest step under `directory` with a complete manifest."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, example_tree: Any,
                       shardings: Any = None, step: Optional[int] = None
                       ) -> Optional[tuple[Any, int]]:
    """(tree, step) restored into the structure of `example_tree` (the
    newest step unless `step` is given), or None if there is none.

    The manifest's step, leaf count and structure are checked against the
    request before any leaf is rebuilt; each mismatch raises with both
    sides named, and a requested step that is missing raises. Each tensor
    lands on the device of the example's matching leaf, in the saved
    dtype. `shardings` (a tree of `distributed.sharding.NamedSharding`s
    over the example, a node's covering the leaves below it) places each
    full saved leaf as this rank's shard of the current mesh, whatever
    mesh wrote it (elastic resharding)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step}")
    if not os.path.exists(os.path.join(path, "manifest.json")):
        raise ValueError(f"no checkpoint for step {step} under {directory} "
                         f"(latest complete step: {latest_step(directory)})")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("step", step) != step:
        raise ValueError(
            f"checkpoint {path} manifest claims step "
            f"{manifest.get('step')} but was requested as step {step}")
    flat_ex, structure = tree_flatten(example_tree)
    n_saved = manifest.get("n_arrays", len(flat_ex))
    if n_saved != len(flat_ex):
        raise ValueError(
            f"checkpoint {path} holds {n_saved} leaves but the requested "
            f"tree has {len(flat_ex)} — the state structure changed since "
            f"this checkpoint was written")
    saved = manifest.get("treedef")
    if saved is not None and saved != structure:
        raise ValueError(
            f"checkpoint {path} tree structure does not match the "
            f"requested tree.\n  saved:     {saved}\n  requested: "
            f"{structure} — leaves would be zipped into the wrong slots")
    dtypes = manifest.get("dtypes", [])
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = iter([_from_host(data[f"a{i}"],
                                  dtypes[i] if i < len(dtypes) else "",
                                  ex)
                       for i, ex in enumerate(flat_ex)])
    tree = tree_map(lambda _: next(leaves), example_tree)
    if shardings is not None:
        from repro_torch.distributed.sharding import place
        tree = place(tree, shardings)
    return tree, step
