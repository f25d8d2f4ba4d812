"""Checkpoint / resume for odometry and mapping state.

Counterpart of ``loam_tpu.checkpoint``, with the same file schema, so that a
checkpoint written by one package loads in the other. Any nest of
NamedTuples, tuples, lists and dicts whose leaves are tensors, arrays or
numbers round-trips through one ``.npz`` file: leaf ``i`` is stored under
``"{i:04d}|{path}"``, the path spelled as ``jax.tree_util.keystr`` spells it
(``.field`` for a NamedTuple field, ``[i]`` for a sequence item, ``['key']``
for a dict entry, dict keys sorted; ``None`` and empty tuples hold no leaf).
:func:`load` rebuilds into the shape of a template (e.g. a fresh
``scan_to_map_init()`` state) and puts each leaf on the template's device.

The port's ``ScanToMapState`` has one leaf ``loam_tpu``'s lacks: ``dropped``
(:data:`PORT_ONLY_LEAVES`). A file without it loads, the template's value
standing in; to write a file that ``loam_tpu`` loads, save the state with
``dropped=None``.
"""

from __future__ import annotations

import os
from typing import Any, List, Tuple

import numpy as np
import torch

#: Fields of the port's state types that ``loam_tpu``'s files lack, matched
#: as the last component of a leaf's path (a state may sit inside a nest).
PORT_ONLY_LEAVES = (".dropped",)


def _port_only(name: str) -> bool:
    return name.rsplit("/", 1)[-1] in PORT_ONLY_LEAVES


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path name, leaf) pairs in ``jax.tree_util``'s order and spelling."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", x) for i, x in enumerate(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [leaf for key, sub in items for leaf in _flatten(sub, prefix + (key,))]


def _leaf_names(tree: Any):
    pairs = _flatten(tree)
    return [n for n, _ in pairs], [leaf for _, leaf in pairs]


def _unflatten(template: Any, values) -> Any:
    """``template`` with its leaves replaced, in order, from ``values``."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), values) for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, values) for x in template)
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], values) for k in sorted(template)}
        return {k: out[k] for k in template}
    return next(values)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, state: Any) -> None:
    """Write a nest of tensors to ``path`` (.npz, atomic rename)."""
    names, leaves = _leaf_names(state)
    arrays = {f"{i:04d}|{name}": _to_numpy(leaf) for i, (name, leaf) in enumerate(zip(names, leaves))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load(path: str, template: Any) -> Any:
    """Read a checkpoint written by :func:`save` (of either package).

    ``template`` supplies the structure and the device of each leaf; the
    values come from the file. Raises ``ValueError`` if the stored leaf
    names differ from the template's (a state-schema change), apart from
    :data:`PORT_ONLY_LEAVES` missing from the file.
    """
    names, leaves = _leaf_names(template)
    devs = [leaf.device for leaf in leaves if isinstance(leaf, torch.Tensor)]
    default_dev = devs[0] if devs else torch.device("cpu")
    with np.load(path) as data:
        keys = sorted(data.files, key=lambda k: int(k.split("|", 1)[0]))
        stored = {k.split("|", 1)[1]: data[k] for k in keys}
        stored_names = list(stored)
    expected = [n for n in names if n in stored or not _port_only(n)]
    if len(stored_names) != len(expected):
        raise ValueError(f"checkpoint {path} has {len(stored_names)} leaves, "
                         f"template has {len(expected)}")
    if stored_names != expected:
        diff = [(a, b) for a, b in zip(stored_names, expected) if a != b][:3]
        raise ValueError(f"checkpoint/template leaf mismatch, e.g. {diff}")
    values = []
    for name, leaf in zip(names, leaves):
        if name not in stored:
            values.append(leaf)  # a port-only leaf the file lacks
            continue
        dev = leaf.device if isinstance(leaf, torch.Tensor) else default_dev
        values.append(torch.from_numpy(np.array(stored[name])).to(dev))
    return _unflatten(template, iter(values))
