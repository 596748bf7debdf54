"""Atomic checkpoints and the durable-session store (ports
``src/repro/ckpt/checkpoint.py``), with the same files on disk.

Two layers:

* :class:`Checkpointer` — checkpoints of nested dicts, lists and tuples of
  arrays.  Layout: ``<dir>/step_<8 digits>/manifest.json`` plus one ``.npy``
  per leaf, named ``"{params|opt}__" + key.replace("/", "__")``, each with
  a CRC-32 of its bytes in the manifest.  Saves are atomic (written to
  ``step_<n>.tmp``, then renamed; orphaned ``.tmp`` directories of crashed
  saves are swept by the next save), and ``restore_latest`` skips a corrupt
  step, newest first.
* :class:`SessionStore` — the backing store of a durable
  :class:`~repro_torch.api.session.PageRankSession`: ``meta.json`` (atomic
  write), ``ckpt/`` (a Checkpointer of {ranks, edges} keyed by the batch
  index it captures) and ``wal.bin``, a write-ahead log of the applied
  update batches.

WAL framing (little-endian), byte for byte the reference's: per record
``b"WR1\\n" | u32 payload_len | u32 crc32(payload) | payload``; the payload
packs ``u64 batch_index | u8 variant | u32 n_dels | u32 n_ins`` and then the
two int64 edge arrays.  Appends are flushed and fsync'd before the batch
touches device state; readers accept exactly the valid prefix of the log.

Leaf keys are the ones ``jax.tree_util.tree_flatten_with_path`` gives the
reference: dict keys sorted and joined by ``/``, list and tuple positions
as their index, ``None`` an empty subtree; a scalar leaf is saved as a 0-d
array.  ``restore`` returns numpy arrays, or tensors on ``device=``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree) -> Dict[str, Any]:
    """Leaves of a nested dict/list/tuple keyed by their ``/``-joined path,
    in the reference's order (dict keys sorted)."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat


def _unflatten(template, leaves: Iterator[Any]):
    """``template``'s structure with its leaves taken, in order, from
    ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, params, opt_state, step: int) -> str:
        self._sweep_tmp()           # also clears any stale tmp for `step`
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp)
        manifest = {"step": int(step), "leaves": {}}
        for name, tree in (("params", params), ("opt", opt_state)):
            for key, leaf in _flatten_with_paths(tree).items():
                arr = _host(leaf)
                fname = f"{name}__{key.replace('/', '__')}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][f"{name}/{key}"] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
        self._gc()
        return final

    def _sweep_tmp(self) -> None:
        """Remove orphaned ``step_<n>.tmp`` dirs left by crashed saves."""
        for d in os.listdir(self.dir):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def _gc(self) -> None:
        steps = sorted(self._list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _list_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d,
                                               "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return out

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, params_like, opt_like, *, shardings=None,
                device=None) -> Tuple[Any, Any, int]:
        """Restore onto the templates' tree structure: numpy arrays, or
        tensors on ``device`` when one is given.  Raises ``IOError`` when a
        leaf's checksum does not match its manifest."""
        if shardings is not None:
            raise NotImplementedError(
                "shardings= places a restore on a device mesh: ROADMAP item "
                "A 15b (the trainer and dist/sharding.py, its only caller) "
                "brings it to the port")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load_tree(name, template):
            loaded = []
            for key in _flatten_with_paths(template):
                meta = manifest["leaves"][f"{name}/{key}"]
                arr = np.load(os.path.join(d, meta["file"]))
                if (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != meta["crc"]:
                    raise IOError(f"checksum mismatch for {name}/{key}")
                loaded.append(arr if device is None
                              else torch.as_tensor(arr, device=device))
            return _unflatten(template, iter(loaded))

        params = load_tree("params", params_like)
        opt = load_tree("opt", opt_like)
        return params, opt, manifest["step"]

    def restore_latest(self, params_like=None, opt_like=None, *,
                       shardings=None, device=None):
        """Restore the newest checkpoint that passes validation.  A step
        whose manifest is unreadable or whose per-leaf checksum mismatches
        is *skipped* (newest→oldest scan).  Returns ``None`` when no valid
        checkpoint remains."""
        steps = sorted(self._list_steps())
        if not steps:
            return None
        if params_like is None:
            raise ValueError("restore_latest needs template pytrees")
        for step in reversed(steps):
            try:
                return self.restore(step, params_like, opt_like,
                                    shardings=shardings, device=device)
            except (OSError, IOError, KeyError, ValueError,
                    json.JSONDecodeError):
                continue             # corrupted step → fall back to previous
        return None

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._list_steps()
        return max(steps) if steps else None


# ---------------------------------------------------------------------------
# durable-session store (process fault domain)
# ---------------------------------------------------------------------------

_WAL_MAGIC = b"WR1\n"
_WAL_HEAD = struct.Struct("<4sII")          # magic, payload_len, crc32
_WAL_PAYLOAD_HEAD = struct.Struct("<QBII")  # batch_index, variant, nd, ni

# WAL variant codes (order is the on-disk format — append only)
WAL_VARIANTS = ("static", "nd", "dt", "df")


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One durably-logged update batch."""
    batch_index: int
    variant: str
    deletions: np.ndarray      # [k, 2] int64
    insertions: np.ndarray     # [k, 2] int64


class SessionStore:
    """Directory-backed durability for one PageRank session: atomic
    {ranks, edges} checkpoints keyed by batch index and a crash-tolerant WAL
    of the batches applied since.  Restore = newest valid checkpoint plus a
    replay of every WAL record with a higher batch index, which the session
    layer drives through its normal update path."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.ckpt = Checkpointer(os.path.join(directory, "ckpt"), keep=keep)
        self.wal_path = os.path.join(directory, "wal.bin")

    # -- meta ----------------------------------------------------------------
    def write_meta(self, meta: dict) -> None:
        tmp = os.path.join(self.dir, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "meta.json"))

    def read_meta(self) -> Optional[dict]:
        path = os.path.join(self.dir, "meta.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # -- checkpoints ----------------------------------------------------------
    @staticmethod
    def _template() -> dict:
        # shapes and dtypes come from the manifest; the template only
        # carries the tree structure (keys)
        return {"ranks": np.zeros(0), "edges": np.zeros((0, 2), np.int64)}

    def checkpoint(self, *, ranks: np.ndarray, edges: np.ndarray,
                   batch_index: int) -> str:
        """Atomically persist the session state *after* ``batch_index``
        batches have been applied, then compact the WAL to the records
        after the OLDEST retained checkpoint (every restore starts from a
        retained checkpoint, so older records can never be replayed)."""
        state = {"ranks": np.asarray(ranks),
                 "edges": np.asarray(edges, np.int64)}
        path = self.ckpt.save(state, {}, batch_index)
        steps = self.ckpt._list_steps()
        if steps:
            self.compact_wal(keep_after=min(steps))
        return path

    def compact_wal(self, *, keep_after: int) -> None:
        """Atomically rewrite the WAL keeping only records with
        ``batch_index > keep_after`` (tmp + rename: a crash mid-compaction
        leaves the old complete log)."""
        if not os.path.exists(self.wal_path):
            return
        recs = self.read_wal(after=keep_after)
        tmp = self.wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for r in recs:
                f.write(self._encode_record(r.batch_index, r.variant,
                                            r.deletions, r.insertions))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.wal_path)

    def restore_latest_state(self) -> Optional[Tuple[dict, int]]:
        """(state, batch_index) of the newest valid checkpoint, skipping
        corrupted steps; None when the store holds no valid checkpoint."""
        got = self.ckpt.restore_latest(self._template(), {})
        if got is None:
            return None
        state, _, step = got
        return ({k: np.asarray(v) for k, v in state.items()}, int(step))

    @property
    def latest_checkpoint_index(self) -> Optional[int]:
        return self.ckpt.latest_step

    # -- write-ahead log ------------------------------------------------------
    @staticmethod
    def _encode_record(batch_index: int, variant: str,
                       deletions: np.ndarray, insertions: np.ndarray
                       ) -> bytes:
        dels = np.ascontiguousarray(
            np.asarray(deletions, np.int64).reshape(-1, 2))
        ins = np.ascontiguousarray(
            np.asarray(insertions, np.int64).reshape(-1, 2))
        payload = (_WAL_PAYLOAD_HEAD.pack(
            int(batch_index), WAL_VARIANTS.index(variant),
            dels.shape[0], ins.shape[0])
            + dels.tobytes() + ins.tobytes())
        return _WAL_HEAD.pack(_WAL_MAGIC, len(payload),
                              zlib.crc32(payload) & 0xFFFFFFFF) + payload

    def append_wal(self, *, batch_index: int, variant: str,
                   deletions: np.ndarray, insertions: np.ndarray) -> None:
        """Durably append one batch BEFORE it is applied to session state
        (flush + fsync): after a crash the record either exists completely
        or is a truncated tail the reader drops."""
        frame = self._encode_record(batch_index, variant, deletions,
                                    insertions)
        with open(self.wal_path, "ab") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())

    def read_wal(self, *, after: int = -1) -> List[WalRecord]:
        """Every valid WAL record with ``batch_index > after``, in append
        order.  Scanning stops at the first truncated or checksum-broken
        frame (the crash tail): the valid prefix is the durable state."""
        if not os.path.exists(self.wal_path):
            return []
        with open(self.wal_path, "rb") as f:
            buf = f.read()
        out: List[WalRecord] = []
        off = 0
        while off + _WAL_HEAD.size <= len(buf):
            magic, plen, crc = _WAL_HEAD.unpack_from(buf, off)
            start = off + _WAL_HEAD.size
            if magic != _WAL_MAGIC or start + plen > len(buf):
                break                          # truncated / corrupt tail
            payload = buf[start:start + plen]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                break
            bidx, var, nd, ni = _WAL_PAYLOAD_HEAD.unpack_from(payload, 0)
            body = payload[_WAL_PAYLOAD_HEAD.size:]
            need = (nd + ni) * 2 * 8
            if len(body) != need or var >= len(WAL_VARIANTS):
                break
            dels = np.frombuffer(body[:nd * 16], np.int64).reshape(-1, 2)
            ins = np.frombuffer(body[nd * 16:], np.int64).reshape(-1, 2)
            if bidx > after:
                out.append(WalRecord(batch_index=int(bidx),
                                     variant=WAL_VARIANTS[var],
                                     deletions=dels.copy(),
                                     insertions=ins.copy()))
            off = start + plen
        return out

    def wal_size(self) -> int:
        """Current WAL length in bytes (0 when no log exists) — taken
        before an append to make it revocable by :meth:`truncate_wal`."""
        return (os.path.getsize(self.wal_path)
                if os.path.exists(self.wal_path) else 0)

    def truncate_wal(self, size: int) -> None:
        """Roll the WAL back to a byte offset: a batch the session rejected
        after its record was appended must not be replayed by a later
        restore, since the session never held it."""
        if os.path.exists(self.wal_path):
            with open(self.wal_path, "rb+") as f:
                f.truncate(size)
                f.flush()
                os.fsync(f.fileno())

    def wal_tip(self) -> int:
        """Highest durably-logged batch index (-1 for an empty WAL)."""
        recs = self.read_wal()
        return recs[-1].batch_index if recs else -1
