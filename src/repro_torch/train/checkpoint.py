"""Tiered checkpointing with Lucene's durability semantics (port of
``repro/train/checkpoint.py``).

  flush()   = NRT reopen: every leaf of the state stored into a
              byte-addressable local heap (``storage/heap.py``) and one
              barrier.  Survives a process crash; cheap enough to run every
              few steps.
  commit()  = Lucene commit point: ``np.savez`` of the leaves, fsync, then
              an fsynced manifest renamed into place.  Survives node loss.
  restore() = reader reopen: the newer of the flush generation and the
              newest commit point.

The files are the reference's byte for byte: the heap's records,
``flush_meta.json``, ``commit_<step>.npz`` with members ``a0..aN`` and
``manifest_<step>.json`` (its ``ts`` is the write time).  Leaves are taken
in ``jax.tree.flatten`` order (``train/tree.py``), so either package
restores the other's flush and commit tiers.  A leaf is a tensor (copied
to the host), a numpy array or a Python scalar.  The heap has no wire code
for bfloat16, and neither has the reference's: a bfloat16 leaf raises
``TypeError`` naming it, on both tiers.

``restore`` takes the structure of ``like`` and places each leaf on the
device and in the dtype of ``like``'s leaf; with ``shardings`` (a tree of
``distributed/api.py::NamedSharding`` s or None, shaped like ``like``) a
leaf with a sharding is placed on its mesh by ``distribute_tensor``: the
reference's elastic re-shard, a state committed under one mesh restored
under another (or none).  A DTensor leaf is written whole
(``full_tensor``, a collective: every rank of its mesh calls ``flush`` or
``commit``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.api import sharding_leaves
from repro_torch.storage.heap import PersistentHeap
from repro_torch.train.tree import tree_flatten, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    flush_every: int = 5  # steps between NRT flushes (cheap tier)
    commit_every: int = 50  # steps between durable commits
    keep_commits: int = 3
    heap_capacity: int = 1 << 28


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a checkpoint cannot hold a bfloat16 leaf: the "
                            "persistent heap has no wire code for bfloat16")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> List[np.ndarray]:
    return [_host(l) for l in tree_leaves(tree)]


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig) -> None:
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._heap = PersistentHeap(
            os.path.join(cfg.directory, "flush.pmem"), cfg.heap_capacity
        )
        self._flush_meta = os.path.join(cfg.directory, "flush_meta.json")
        self.stats = {"flushes": 0, "commits": 0, "flush_s": 0.0, "commit_s": 0.0}

    @property
    def heap(self) -> PersistentHeap:
        """The flush tier's heap (its ``stats`` count barriers and stores)."""
        return self._heap

    # -- tier 1: NRT flush (byte path) ---------------------------------------
    def _write_flush_meta(self, step: int, offs: List[int]) -> None:
        with open(self._flush_meta + ".tmp", "w") as f:
            json.dump({"step": step, "offsets": offs}, f)
        os.replace(self._flush_meta + ".tmp", self._flush_meta)

    def flush(self, step: int, state: Any) -> float:
        """Fast local snapshot; returns seconds spent."""
        t0 = time.perf_counter()
        leaves = _flatten(state)
        offs = [self._heap.store(l) for l in leaves]
        self._heap.barrier()
        self._write_flush_meta(step, offs)
        # reclaim: restart the bump allocator once the heap fills past half
        if self._heap.tail > self._heap.capacity // 2:
            self._compact(step)
        dt = time.perf_counter() - t0
        self.stats["flushes"] += 1
        self.stats["flush_s"] += dt
        return dt

    def _compact(self, step: int) -> None:
        """Copy the live snapshot to a fresh heap (segment-merge analogue)."""
        with open(self._flush_meta) as f:
            meta = json.load(f)
        live = [self._heap.load(o).copy() for o in meta["offsets"]]
        self._heap.close()
        os.remove(self._heap.path)
        self._heap = PersistentHeap(self._heap.path, self.cfg.heap_capacity)
        offs = [self._heap.store(l) for l in live]
        self._heap.barrier()
        self._write_flush_meta(step, offs)

    # -- tier 2: durable commit (file path) -----------------------------------
    def commit(self, step: int, state: Any, extra: Optional[dict] = None) -> float:
        t0 = time.perf_counter()
        leaves = _flatten(state)
        path = os.path.join(self.cfg.directory, f"commit_{step:09d}.npz")
        with open(path + ".tmp", "wb") as f:
            np.savez(f, **{f"a{i}": l for i, l in enumerate(leaves)})
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)
        manifest = {
            "step": step,
            "file": os.path.basename(path),
            "ts": time.time(),
            "extra": extra or {},
        }
        mpath = os.path.join(self.cfg.directory, f"manifest_{step:09d}.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mpath + ".tmp", mpath)  # the commit point
        self._gc()
        dt = time.perf_counter() - t0
        self.stats["commits"] += 1
        self.stats["commit_s"] += dt
        return dt

    def _manifests(self) -> List[str]:
        return sorted(f for f in os.listdir(self.cfg.directory) if f.startswith("manifest_"))

    def _gc(self) -> None:
        for m in self._manifests()[: -self.cfg.keep_commits]:
            step = m[len("manifest_"):-len(".json")]
            for fn in (m, f"commit_{step}.npz"):
                p = os.path.join(self.cfg.directory, fn)
                if os.path.exists(p):
                    os.remove(p)

    # -- periodic driver -------------------------------------------------------
    def maybe_snapshot(self, step: int, state: Any) -> Optional[str]:
        if step > 0 and step % self.cfg.commit_every == 0:
            self.commit(step, state)
            return "commit"
        if step > 0 and step % self.cfg.flush_every == 0:
            self.flush(step, state)
            return "flush"
        return None

    # -- restore ----------------------------------------------------------------
    def latest(self) -> Tuple[Optional[int], Optional[str]]:
        """(step, tier) of the newest restorable snapshot."""
        flush_step = -1
        if os.path.exists(self._flush_meta):
            try:
                with open(self._flush_meta) as f:
                    flush_step = json.load(f)["step"]
            except (json.JSONDecodeError, KeyError):
                flush_step = -1
        manifests = self._manifests()
        commit_step = int(manifests[-1][9:-5]) if manifests else -1
        if flush_step < 0 and commit_step < 0:
            return None, None
        if flush_step >= commit_step:
            return flush_step, "flush"
        return commit_step, "commit"

    def restore(self, like: Any, shardings: Any = None,
                tier: Optional[str] = None) -> Tuple[Optional[int], Any]:
        """Restore into the structure of ``like``: each tensor leaf in the
        shape, dtype and device of ``like``'s leaf (a numpy leaf stays numpy),
        then, where ``shardings`` gives the leaf a sharding, distributed on
        its mesh (elastic re-shard).
        The heap stores a 0-d array as shape (1,) (``np.ascontiguousarray``,
        in both packages); the reference's flush tier gives its step back
        so, the port reshapes it to the state's 0-d step."""
        step, found = self.latest()
        if step is None:
            return None, like
        tier = tier or found
        like_leaves, treedef = tree_flatten(like)
        if tier == "flush":
            with open(self._flush_meta) as f:
                meta = json.load(f)
            leaves = [self._heap.load(o).copy() for o in meta["offsets"]]
            step = meta["step"]
        else:
            with open(os.path.join(self.cfg.directory, self._manifests()[-1])) as f:
                meta = json.load(f)
            step = meta["step"]
            with np.load(os.path.join(self.cfg.directory, meta["file"])) as z:
                leaves = [z[f"a{i}"] for i in range(len(z.files))]
        if len(leaves) != len(like_leaves):
            raise ValueError(f"checkpoint at step {step} holds {len(leaves)} leaves, "
                             f"the state {len(like_leaves)}")
        shard_leaves = (sharding_leaves(shardings) if shardings is not None
                        else [None] * len(like_leaves))
        out = []
        for l, ll, sh in zip(leaves, like_leaves, shard_leaves):
            if isinstance(ll, torch.Tensor):
                t = torch.from_numpy(l).reshape(ll.shape).to(device=ll.device, dtype=ll.dtype)
                if sh is not None:
                    from torch.distributed.tensor import distribute_tensor

                    t = distribute_tensor(t, sh.mesh, sh.placements)
                out.append(t)
            elif hasattr(ll, "dtype"):
                out.append(np.asarray(l).astype(ll.dtype))
            else:
                out.append(l)
        return step, tree_unflatten(treedef, out)

    def simulate_process_crash(self) -> None:
        """Drop everything since the last barrier (flush survives)."""
        self._heap.truncate_to_committed()

    def simulate_node_loss(self) -> None:
        """Local heap is gone; only the durable tier remains."""
        self._heap.close()
        os.remove(self._heap.path)
        if os.path.exists(self._flush_meta):
            os.remove(self._flush_meta)
        self._heap = PersistentHeap(
            os.path.join(self.cfg.directory, "flush.pmem"),
            self.cfg.heap_capacity,
        )
