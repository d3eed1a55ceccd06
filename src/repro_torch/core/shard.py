"""Shard plumbing: document routers + the per-shard Directory set (port of
``repro/core/shard.py``; the manifest and the ``shardNN/`` layout are the
reference's byte for byte, so each package opens the other's index).

Lucene's ``IndexWriter`` scales ingest with *DocumentsWriterPerThread*
(DWPT): each indexing thread owns a private DRAM buffer and flushes its own
segments, so writers never contend.  Lin's "Performance Envelope of
Inverted Indexing" measurements say this writer parallelism — not scoring —
is what gates indexing throughput on real hardware.  This module supplies
the two static ingredients of that design for our engine:

  * **Routers** decide which shard indexes a document.  ``HashIdRouter``
    spreads documents round-robin by external doc id (DWPT's "any free
    writer" behavior, made deterministic); ``HashFieldRouter`` hashes a
    routing field's raw value, so all documents sharing a key co-locate
    (Elasticsearch-style ``_routing``).  A router is part of the index's
    durable identity: its spec is persisted in the cross-shard manifest and
    restored on recovery, because replaying documents through a *different*
    router would silently split the corpus differently.

  * **ShardSet** owns N sibling ``Directory`` instances — one per shard —
    and the **cross-shard manifest**, the tiny root record that makes N
    independent per-shard commits act like one atomic commit point (see
    ``core/sharded.py::ShardedWriter.commit`` for the two-phase
    protocol).  Each directory kind shards the way it persists:
    ``ram`` gets N independent in-memory stores, ``fs-*`` gets one
    subdirectory per shard (``shard00/ ...``), and ``byte-*`` gets one
    *PersistentHeap per shard* under its own subpath — per-shard heaps are
    what keep the byte path's single-barrier commit true per shard (N
    small barriers that could run concurrently, instead of one giant heap
    serializing every writer).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

from repro_torch.core.analyzer import _fnv1a
from repro_torch.core.directory import Directory, make_directory

MANIFEST_NAME = "shards.json"


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------


class Router:
    """Maps a document to a shard.  Must be deterministic: recovery and the
    sharded-vs-unsharded parity oracle both rely on replaying the same
    corpus producing the same placement."""

    kind = "base"

    def route(self, fields: Dict[str, str], doc_values: Optional[dict], ext_id: int) -> int:
        raise NotImplementedError

    def spec(self) -> dict:
        """JSON-serializable identity, persisted in the cross-shard
        manifest so recovery reconstructs the *same* router."""
        return {"kind": self.kind}


class HashIdRouter(Router):
    """Round-robin by external doc id — the balanced default (DWPT's
    any-free-writer placement, made deterministic)."""

    kind = "id"

    def __init__(self, n_shards: int) -> None:
        self.n_shards = n_shards

    def route(self, fields, doc_values, ext_id: int) -> int:
        return ext_id % self.n_shards


class HashFieldRouter(Router):
    """Route by FNV-1a hash of one field's raw text: documents sharing the
    routing key co-locate on one shard (Elasticsearch ``_routing``)."""

    kind = "field"

    def __init__(self, n_shards: int, field: str) -> None:
        self.n_shards = n_shards
        self.field = field

    def route(self, fields, doc_values, ext_id: int) -> int:
        return _fnv1a(fields.get(self.field, "").encode("utf-8")) % self.n_shards

    def spec(self) -> dict:
        return {"kind": self.kind, "field": self.field}


def router_from_spec(spec: dict, n_shards: int) -> Optional[Router]:
    """Rebuild a built-in router from its manifest spec (None if the spec
    names a custom router class the caller must supply itself)."""
    if spec.get("kind") == HashIdRouter.kind:
        return HashIdRouter(n_shards)
    if spec.get("kind") == HashFieldRouter.kind:
        return HashFieldRouter(n_shards, spec["field"])
    return None


# ---------------------------------------------------------------------------
# ShardSet: N sibling directories + the cross-shard manifest
# ---------------------------------------------------------------------------


class ShardSet:
    """N per-shard ``Directory`` instances plus the cross-shard manifest.

    The manifest is the *sharded index's* commit point: it records, per
    epoch, the per-shard commit generations that together form one
    consistent point in time, plus the external-id watermark and the
    router spec.  For file-backed kinds it is an fsynced JSON file beside
    the shard subdirectories (atomic tmp+rename, like ``segments_N``); for
    the ``ram`` kind it lives in DRAM and dies in a crash exactly like the
    data it describes.
    """

    def __init__(self, kind: str, path: Optional[str], n_shards: int) -> None:
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.kind = kind
        self.n_shards = n_shards
        if kind == "ram":
            self.path: Optional[str] = None
            self._mem_manifest: Optional[dict] = None
        else:
            self.path = path or tempfile.mkdtemp(prefix=f"repro-torch-shards-{kind}-")
            os.makedirs(self.path, exist_ok=True)
        self.dirs: List[Directory] = [
            make_directory(kind, self.shard_path(i)) for i in range(n_shards)
        ]

    def shard_path(self, i: int) -> Optional[str]:
        """Filesystem home of shard ``i`` (None for the ram kind) — what a
        worker process needs to build its own ``Directory`` over the same
        durable bytes."""
        if self.path is None:
            return None
        return os.path.join(self.path, f"shard{i:02d}")

    def reload(self) -> None:
        """Rebuild ``self.dirs`` from storage, dropping in-memory state.

        Under the processes backend the coordinator's ``Directory`` objects
        are stale mirrors — the workers own the real ones and advance the
        committed watermarks.  Recovery paths must reload from the durable
        bytes *before* simulating a crash, or the stale watermark would
        truncate data a worker durably committed.  Meaningless for ``ram``
        (nothing durable to reload from), so it is a no-op there.
        """
        if self.kind == "ram":
            return
        for d in self.dirs:
            d.close()
        self.dirs = [
            make_directory(self.kind, self.shard_path(i))
            for i in range(self.n_shards)
        ]

    # -- manifest -----------------------------------------------------------
    @property
    def _manifest_path(self) -> Optional[str]:
        return None if self.path is None else os.path.join(self.path, MANIFEST_NAME)

    def read_manifest(self) -> Optional[dict]:
        if self.path is None:
            return self._mem_manifest
        p = self._manifest_path
        if p is None or not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def write_manifest(self, rec: dict) -> None:
        """Durably publish one cross-shard commit point (atomic flip)."""
        if self.path is None:
            self._mem_manifest = dict(rec)
            return
        p = self._manifest_path
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, p)

    # -- failure ------------------------------------------------------------
    def crash(self) -> None:
        """Power failure hits every shard at once; the in-memory manifest
        of the ram kind is lost with its data (file-backed manifests were
        fsynced and survive)."""
        for d in self.dirs:
            d.crash()
        if self.path is None:
            self._mem_manifest = None
