"""SegmentInfos: the immutable point-in-time view of an index (port of
``repro/core/lifecycle/infos.py``, unchanged: host-side Python).

Lucene's ``SegmentInfos`` is the unit a reader opens: the list of segments
(and each one's deletion state) as of one instant.  Here it is a frozen
dataclass holding a tuple of ``Segment`` objects that are themselves treated
as immutable under a copy-on-write discipline:

  * a buffered delete never touches ``seg.live`` in place — the writer swaps
    in a *clone* (``Segment.with_live``) and publishes a new infos;
  * a merge never rebases ``base_doc`` in place — trailing segments are
    rebased through clones (``Segment.with_base``) in the new infos.

So any ``Searcher`` holding an older ``SegmentInfos`` keeps a bit-identical
view while the writer flushes, deletes, and merges underneath it — the
property the paper's NRT measurements (Fig 4a/4b) assume.

``generation`` increases on every published change; ``SearcherManager``
compares generations to decide whether a reopen must swap searchers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.segment import Segment


def _rebased(segments: Sequence[Segment]) -> Tuple[Segment, ...]:
    """Assign contiguous global doc-id bases via clones (never in place)."""
    out: List[Segment] = []
    base = 0
    for seg in segments:
        out.append(seg.with_base(base))
        base += seg.n_docs
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SegmentInfos:
    """Immutable snapshot: (name, base_doc, live-bitmap ref) per segment."""

    generation: int
    segments: Tuple[Segment, ...]

    # -- constructors -------------------------------------------------------
    @staticmethod
    def empty() -> "SegmentInfos":
        return SegmentInfos(generation=0, segments=())

    @staticmethod
    def opened(segments: Sequence[Segment]) -> "SegmentInfos":
        """First snapshot after recovery from a commit point."""
        return SegmentInfos(generation=1, segments=_rebased(segments))

    # -- accessors ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.segments)

    def __iter__(self):
        return iter(self.segments)

    def names(self) -> List[str]:
        return [s.name for s in self.segments]

    def by_name(self) -> Dict[str, Segment]:
        return {s.name: s for s in self.segments}

    @property
    def total_docs(self) -> int:
        return sum(s.n_docs for s in self.segments)

    @property
    def total_live_docs(self) -> int:
        return sum(s.n_live for s in self.segments)

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.segments)

    # -- transitions (each returns a NEW snapshot, generation + 1) ----------
    def with_flushed(self, seg: Segment) -> "SegmentInfos":
        """Append a freshly flushed segment."""
        return SegmentInfos(self.generation + 1, self.segments + (seg,))

    def with_replaced(self, replacements: Dict[str, Segment]) -> "SegmentInfos":
        """Swap segments by name (deletes publish live-bitmap clones here)."""
        segs = tuple(replacements.get(s.name, s) for s in self.segments)
        return SegmentInfos(self.generation + 1, segs)

    def with_merged(
        self, merged_away: Sequence[str], merged: Optional[Segment]
    ) -> "SegmentInfos":
        """Replace ``merged_away`` members with ``merged`` (placed at the
        first member's position) and rebase trailing segments via clones.
        ``merged=None`` drops the members entirely (merge output was empty —
        every doc was deleted)."""
        gone = set(merged_away)
        segs: List[Segment] = []
        inserted = False
        for s in self.segments:
            if s.name in gone:
                if not inserted and merged is not None:
                    segs.append(merged)
                    inserted = True
                continue
            segs.append(s)
        return SegmentInfos(self.generation + 1, _rebased(segs))
