"""Atomic, async checkpoints in the reference's format (counterpart of
``repro.checkpoint.checkpointer``).

Format: one directory per step, ``step_XXXXXXXXXX/``, holding

  arrays.npz    — the tree's leaves as full arrays, ``leaf_{i}``
  meta.msgpack  — step, leaf count, the tree's structure as a string,
                  user metadata

written under ``<dir>.tmp`` and then renamed, so a crash mid-save never
corrupts the latest checkpoint; ``keep_last_k`` garbage collection;
``save_async`` snapshots the tree to the host, then writes in a daemon
thread.

The leaves are written in JAX's flatten order (dict keys sorted, lists
in order, ``AdamWState`` as (step, mu, nu)), and an LM param tree — a
dict whose "blocks" is the port's per-layer list, as are its gradients
and optimizer moments — in the reference's stacked ``blocks.scan.b{j}``
layout (``convert.stack_blocks``; this needs the model's config).  The
structure string is the one JAX prints for the same tree.  So a
checkpoint of a train state written by either package restores in the
other.  ``meta.msgpack`` is written and read by the small msgpack subset
below (dict, list, str, bytes, int, float, bool, None), which gives the
``msgpack`` package's bytes.
"""
from __future__ import annotations

import os
import shutil
import struct
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.convert import (leaf_to_numpy, params_from_numpy,
                                 stack_blocks)
from repro_torch.nn.transformer import ModelConfig
from repro_torch.train.optimizer import (AdamWState, tree_leaves, tree_map,
                                         tree_unflatten)


# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------

def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32),
                                   (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(obj)
        else:
            for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)),
                                      (0xD1, ">h", -(1 << 15)),
                                      (0xD2, ">i", -(1 << 31)),
                                      (0xD3, ">q", -(1 << 63))):
                if obj >= bottom:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
            else:
                raise OverflowError(obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_sized(out, obj.encode(), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += obj.encode()
    elif isinstance(obj, bytes):
        _pack_sized(out, obj, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_sized(out, obj, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_sized(out, obj, 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_sized(out: bytearray, obj, fix, fix_n: int, codes) -> None:
    """The header of a str, bin, array or map of len(obj) items: the
    fix form below `fix_n`, else the 8-, 16- or 32-bit length form."""
    n = len(obj)
    if fix is not None and n < fix_n:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for dicts, lists, tuples, str, bytes, int,
    float, bool and None."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: bytes, i: int):
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], i
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if 0xA0 <= code < 0xC0:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code < 0xA0:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not supported")
    if kind in ("str", "bin"):
        raw = bytes(buf[i:i + n])
        return (raw.decode() if kind == "str" else raw), i + n
    items = []
    for _ in range(n * (2 if kind == "map" else 1)):
        item, i = _unpack(buf, i)
        items.append(item)
    if kind == "array":
        return items, i
    return dict(zip(items[::2], items[1::2])), i


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for what ``packb`` writes (and f32)."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# trees in the reference's layout
# ---------------------------------------------------------------------------

def _is_lm_params(node) -> bool:
    return isinstance(node, dict) and isinstance(node.get("blocks"), list)


def _ref_layout(tree, cfg: ModelConfig | None, leaf, stack):
    """`tree` with its LM param trees restacked as the reference's:
    `leaf` maps every leaf, `stack` a list of mapped per-layer leaves to
    their stacked leaf."""
    def go(node):
        if _is_lm_params(node):
            if cfg is None:
                raise ValueError("an LM param tree needs the model's "
                                 "config: Checkpointer(..., cfg=cfg)")
            out = {k: go(v) for k, v in node.items() if k != "blocks"}
            out["blocks"] = stack_blocks(
                node["blocks"], len(cfg.pattern),
                lambda leaves: stack([leaf(x) for x in leaves]))
            return out
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        if isinstance(node, AdamWState):
            return AdamWState(go(node.step), go(node.mu), go(node.nu))
        return None if node is None else leaf(node)
    return go(tree)


def _meta(leaf) -> torch.Tensor:
    """A storage-free stand-in with `leaf`'s shape."""
    return torch.empty(tuple(np.shape(leaf)), device="meta")


def _stack_meta(leaves: list) -> torch.Tensor:
    return torch.empty((len(leaves), *leaves[0].shape), device="meta")


def treedef_str(tree) -> str:
    """``str(jax.tree.structure(tree))`` for dicts, lists, tuples, None
    and ``AdamWState``."""
    def go(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {go(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(go(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(go(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, AdamWState):
            return (f"CustomNode(AdamWState[()], [{go(node.step)}, "
                    f"{go(node.mu)}, {go(node.nu)}])")
        return "*"
    return f"PyTreeDef({go(tree)})"


def _write_like(arr: np.ndarray, like):
    """`arr` written over the tensor `like` (its device and dtype kept);
    an array of `like`'s dtype where `like` is not a tensor."""
    if isinstance(like, torch.Tensor):
        return like.copy_(torch.as_tensor(arr))
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def _into_like(ref, like, cfg):
    """The restored reference-layout numpy tree `ref` written into
    `like`'s tensors in place, in `like`'s layout."""
    if _is_lm_params(like):
        return tree_map(_write_like, params_from_numpy(ref, cfg, "cpu"),
                        like)
    if isinstance(like, dict):
        return {k: _into_like(ref[k], v, cfg) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_into_like(r, v, cfg) for r, v in zip(ref, like))
    if isinstance(like, AdamWState):
        return AdamWState(*(_into_like(r, v, cfg) for r, v in zip(
            (ref.step, ref.mu, ref.nu), (like.step, like.mu, like.nu))))
    return None if like is None else _write_like(ref, like)


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------

class Checkpointer:
    def __init__(self, directory: str, keep_last_k: int = 3,
                 cfg: ModelConfig | None = None):
        """`cfg`: the model's config, where the saved trees hold LM
        params (their per-layer list is written stacked by its
        pattern)."""
        self.directory = directory
        self.keep_last_k = keep_last_k
        self.cfg = cfg
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save --------------------------------------------------------------
    def _host_tree(self, tree):
        return _ref_layout(tree, self.cfg, leaf_to_numpy, np.stack)

    def save(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()   # only one outstanding async save
        self._write(int(step), self._host_tree(tree), metadata or {})

    def save_async(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()
        # snapshot to host synchronously, write in the background
        host_tree = self._host_tree(tree)
        self._thread = threading.Thread(
            target=self._write, args=(int(step), host_tree, metadata or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, metadata: dict):
        leaves = tree_leaves(host_tree)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        meta = {"step": step, "n_leaves": len(leaves),
                "treedef": treedef_str(host_tree), "metadata": metadata}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(packb(meta))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_last_k]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, like: Any, step: int | None = None
                ) -> tuple[Any, dict]:
        """Restore into `like` (a tree of tensors or arrays): its tensors
        are overwritten in place, keeping their devices and dtypes, so a
        restore holds no second copy of the state on the device; leaves
        that are not tensors come back as arrays of their dtype.  Returns
        (tree, metadata), the tree in `like`'s structure."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.msgpack"), "rb") as f:
            meta = unpackb(f.read())
        skeleton = _ref_layout(like, self.cfg, _meta, _stack_meta)
        shapes = tree_leaves(skeleton)
        if meta["n_leaves"] != len(shapes):
            raise ValueError(f"leaf count mismatch: checkpoint "
                             f"{meta['n_leaves']} vs {len(shapes)}")
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(shapes))]
        for i, (leaf, ref) in enumerate(zip(leaves, shapes)):
            if tuple(leaf.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} shape {leaf.shape} != expected "
                                 f"{tuple(ref.shape)}")
        with torch.no_grad():
            tree = _into_like(tree_unflatten(skeleton, leaves), like,
                              self.cfg)
        return tree, meta["metadata"]
