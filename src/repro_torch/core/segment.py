"""Immutable index segments (port of ``repro/core/segment.py``).

Host arrays stay numpy, exactly as the reference lays them out, so segments
built by either package are array-identical; ``query/cache.py`` stages the
doc-side arrays and the CSR on the card.

  term_ids          (n_terms,)   int64   sorted unique term hashes
  term_df           (n_terms,)   int32   document frequency per term
  postings_offsets  (n_terms+1,) int32   CSR row pointers into postings
  postings_docs     (nnz,)       int32   segment-local doc ids, sorted per term
  postings_freqs    (nnz,)       int32   term frequency in that doc
  pos_offsets       (nnz+1,)     int32   CSR pointers into positions
  positions         (sum tf,)    int32   token positions
  doc_lens          (n_docs,)    int32   tokens per doc (BM25 length norm)
  live              (n_docs,)    bool    deletion bitmap (False = deleted)
  doc_values[name]  (n_docs,)    int32   columnar doc values
  doc_values[_vec]  (n_docs, d)  float32 dense vectors (zero rows: none)

``build_segment_reference`` / ``merge_segments_reference`` are the
reference's per-term and per-posting loops over a dict buffer, kept as the
bit-parity oracle of the columnar builders and as the writer's
``use_reference_ingest`` path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.columnar import group_sorted


@dataclasses.dataclass
class Segment:
    name: str
    base_doc: int  # global docid of local doc 0
    term_ids: np.ndarray
    term_df: np.ndarray
    postings_offsets: np.ndarray
    postings_docs: np.ndarray
    postings_freqs: np.ndarray
    pos_offsets: np.ndarray
    positions: np.ndarray
    doc_lens: np.ndarray
    live: np.ndarray
    doc_values: Dict[str, np.ndarray]

    @property
    def n_docs(self) -> int:
        return int(self.doc_lens.shape[0])

    @property
    def n_terms(self) -> int:
        return int(self.term_ids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.postings_docs.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def total_tokens(self) -> int:
        return int(self.doc_lens.sum())

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays().values())

    def arrays(self) -> Dict[str, np.ndarray]:
        d = {
            "term_ids": self.term_ids,
            "term_df": self.term_df,
            "postings_offsets": self.postings_offsets,
            "postings_docs": self.postings_docs,
            "postings_freqs": self.postings_freqs,
            "pos_offsets": self.pos_offsets,
            "positions": self.positions,
            "doc_lens": self.doc_lens,
            "live": self.live,
        }
        for k, v in self.doc_values.items():
            d[f"dv.{k}"] = v
        return d

    @staticmethod
    def from_arrays(name: str, base_doc: int, arrays: Dict[str, np.ndarray]) -> "Segment":
        """The inverse of ``arrays()`` (what the directories read back);
        the arrays are taken as they are, not copied."""
        return Segment(
            name=name,
            base_doc=base_doc,
            term_ids=arrays["term_ids"],
            term_df=arrays["term_df"],
            postings_offsets=arrays["postings_offsets"],
            postings_docs=arrays["postings_docs"],
            postings_freqs=arrays["postings_freqs"],
            pos_offsets=arrays["pos_offsets"],
            positions=arrays["positions"],
            doc_lens=arrays["doc_lens"],
            live=arrays["live"],
            doc_values={k[3:]: v for k, v in arrays.items() if k.startswith("dv.")},
        )

    # copy-on-write clones: a published Segment is immutable, so deletes and
    # merges swap in clones sharing every array except the changed field
    def with_live(self, live: np.ndarray) -> "Segment":
        return dataclasses.replace(self, live=live)

    def with_base(self, base_doc: int) -> "Segment":
        if base_doc == self.base_doc:
            return self
        return dataclasses.replace(self, base_doc=base_doc)

    def term_slot(self, th: int) -> int:
        """searchsorted lookup; returns -1 if absent."""
        i = int(np.searchsorted(self.term_ids, th))
        if i < self.n_terms and int(self.term_ids[i]) == th:
            return i
        return -1

    def postings(self, th: int):
        """(docs, freqs) for a term, or empty arrays."""
        i = self.term_slot(th)
        if i < 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z
        s, e = int(self.postings_offsets[i]), int(self.postings_offsets[i + 1])
        return self.postings_docs[s:e], self.postings_freqs[s:e]

    def positions_for(self, th: int, doc_local: int) -> np.ndarray:
        """Token positions of term ``th`` in local doc ``doc_local``."""
        i = self.term_slot(th)
        if i < 0:
            return np.zeros(0, dtype=np.int32)
        s, e = int(self.postings_offsets[i]), int(self.postings_offsets[i + 1])
        j = s + int(np.searchsorted(self.postings_docs[s:e], doc_local))
        if j >= e or int(self.postings_docs[j]) != doc_local:
            return np.zeros(0, dtype=np.int32)
        return self.positions[int(self.pos_offsets[j]) : int(self.pos_offsets[j + 1])]


def build_segment_reference(
    name: str,
    base_doc: int,
    buffer: Dict[int, List],  # term -> [(doc_local, freq, positions)]
    doc_lens: Sequence[int],
    doc_values: Dict[str, np.ndarray],
    live: Optional[np.ndarray] = None,
) -> Segment:
    """Freeze a dict-of-postings buffer into a segment with a per-term loop:
    the bit-parity oracle of ``build_segment_columnar``."""
    n_docs = len(doc_lens)
    terms = np.fromiter(buffer.keys(), dtype=np.int64, count=len(buffer))
    order = np.argsort(terms, kind="stable")
    terms = terms[order]
    keys = list(buffer.keys())

    df = np.zeros(len(terms), dtype=np.int32)
    offsets = np.zeros(len(terms) + 1, dtype=np.int32)
    docs_chunks: List[np.ndarray] = []
    freq_chunks: List[np.ndarray] = []
    pos_lens: List[np.ndarray] = []
    pos_chunks: List[np.ndarray] = []

    for slot, src in enumerate(order):
        plist = buffer[keys[src]]
        d = np.fromiter((p[0] for p in plist), dtype=np.int32, count=len(plist))
        f = np.fromiter((p[1] for p in plist), dtype=np.int32, count=len(plist))
        if len(d) > 1 and not np.all(d[1:] > d[:-1]):  # sort unsorted lists
            o = np.argsort(d, kind="stable")
            d, f = d[o], f[o]
            plist = [plist[i] for i in o]
        docs_chunks.append(d)
        freq_chunks.append(f)
        df[slot] = len(d)
        offsets[slot + 1] = offsets[slot] + len(d)
        for p in plist:
            pos = np.asarray(p[2], dtype=np.int32)
            pos_lens.append(np.int32(len(pos)))
            pos_chunks.append(pos)

    postings_docs = (
        np.concatenate(docs_chunks) if docs_chunks else np.zeros(0, np.int32)
    )
    postings_freqs = (
        np.concatenate(freq_chunks) if freq_chunks else np.zeros(0, np.int32)
    )
    pos_offsets = np.zeros(len(postings_docs) + 1, dtype=np.int32)
    if pos_lens:
        np.cumsum(np.asarray(pos_lens, dtype=np.int32), out=pos_offsets[1:])
    positions = np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, np.int32)

    return Segment(
        name=name,
        base_doc=base_doc,
        term_ids=terms,
        term_df=df,
        postings_offsets=offsets,
        postings_docs=postings_docs.astype(np.int32),
        postings_freqs=postings_freqs.astype(np.int32),
        pos_offsets=pos_offsets,
        positions=positions.astype(np.int32),
        doc_lens=np.asarray(doc_lens, dtype=np.int32),
        live=(live if live is not None else np.ones(n_docs, dtype=bool)),
        doc_values={k: np.asarray(v) for k, v in doc_values.items()},
    )


def merge_segments_reference(
    name: str, base_doc: int, segments: Sequence[Segment]
) -> Segment:
    """Per-posting-loop merge over a dict buffer: the bit-parity oracle of
    ``merge_segments`` (deleted docs dropped, ids remapped densely)."""
    maps: List[np.ndarray] = []
    new_doc_lens: List[np.ndarray] = []
    new_dv: Dict[str, List[np.ndarray]] = {}
    # a member missing a doc-values key contributes zero rows of the
    # column's dtype and trailing shape, as flush pads it
    dv_specs: Dict[str, tuple] = {}
    for seg in segments:
        for k, v in seg.doc_values.items():
            dv_specs.setdefault(k, (v.dtype, v.shape[1:]))
    cursor = 0
    for seg in segments:
        m = np.full(seg.n_docs, -1, dtype=np.int64)
        kept = np.nonzero(seg.live)[0]
        m[kept] = cursor + np.arange(len(kept))
        cursor += len(kept)
        maps.append(m)
        new_doc_lens.append(seg.doc_lens[kept])
        for k, (dt, tail) in dv_specs.items():
            v = seg.doc_values.get(k)
            new_dv.setdefault(k, []).append(
                v[kept] if v is not None
                else np.zeros((len(kept),) + tail, dtype=dt)
            )

    buffer: Dict[int, List] = {}
    for seg, m in zip(segments, maps):
        for slot in range(seg.n_terms):
            th = int(seg.term_ids[slot])
            s, e = int(seg.postings_offsets[slot]), int(seg.postings_offsets[slot + 1])
            plist = buffer.setdefault(th, [])
            for j in range(s, e):
                nd = int(m[int(seg.postings_docs[j])])
                if nd < 0:
                    continue
                pos = seg.positions[
                    int(seg.pos_offsets[j]) : int(seg.pos_offsets[j + 1])
                ]
                plist.append((nd, int(seg.postings_freqs[j]), pos))
            if not plist:
                del buffer[th]

    doc_lens = (
        np.concatenate(new_doc_lens) if new_doc_lens else np.zeros(0, np.int32)
    )
    dv = {k: np.concatenate(v) for k, v in new_dv.items()}
    # postings arrive ordered by (segment, local doc): increasing new ids
    return build_segment_reference(name, base_doc, buffer, doc_lens, dv)


def build_segment_columnar(
    name: str,
    base_doc: int,
    term_col: np.ndarray,       # (n,) int64 term hash per posting
    doc_col: np.ndarray,        # (n,) int32 buffer-local doc id
    freq_col: np.ndarray,       # (n,) int32 term frequency
    pos_off_col: np.ndarray,    # (n,) int64 span start into positions_col
    positions_col: np.ndarray,  # (m,) int32 flat positions (span len == freq)
    doc_lens: Sequence[int],
    doc_values: Dict[str, np.ndarray],
    live: Optional[np.ndarray] = None,
) -> Segment:
    """Freeze columnar posting columns into a segment: one lexsort + CSR."""
    n_docs = len(doc_lens)
    n = len(term_col)
    order = np.lexsort((doc_col, term_col))  # primary term, secondary doc
    starts, term_ids = group_sorted(term_col[order])
    df = np.diff(np.append(starts, n))
    offsets = np.zeros(len(term_ids) + 1, dtype=np.int32)
    if len(df):
        offsets[1:] = np.cumsum(df)

    postings_docs = doc_col[order].astype(np.int32, copy=False)
    postings_freqs = freq_col[order].astype(np.int32, copy=False)

    # gather the per-posting position spans in the new order
    lens = postings_freqs.astype(np.int64)
    pos_offsets = np.zeros(n + 1, dtype=np.int32)
    if n:
        pos_offsets[1:] = np.cumsum(lens)
    total = int(pos_offsets[-1])
    if total:
        src_start = pos_off_col[order]
        row = np.repeat(np.arange(n, dtype=np.int64), lens)
        idx = src_start[row] + (
            np.arange(total, dtype=np.int64) - pos_offsets[:-1].astype(np.int64)[row]
        )
        positions = positions_col[idx]
    else:
        positions = np.zeros(0, dtype=np.int32)

    return Segment(
        name=name,
        base_doc=base_doc,
        term_ids=term_ids.astype(np.int64, copy=False),
        term_df=df.astype(np.int32),
        postings_offsets=offsets,
        postings_docs=postings_docs,
        postings_freqs=postings_freqs,
        pos_offsets=pos_offsets,
        positions=positions.astype(np.int32, copy=False),
        doc_lens=np.asarray(doc_lens, dtype=np.int32),
        live=(live if live is not None else np.ones(n_docs, dtype=bool)),
        doc_values={k: np.asarray(v) for k, v in doc_values.items()},
    )


def _columns_from_buffer(buffer: Dict[int, List]):
    """Expand a dict-of-postings buffer into flat posting columns."""
    terms: List[int] = []
    docs: List[int] = []
    freqs: List[int] = []
    pos_chunks: List[np.ndarray] = []
    for th, plist in buffer.items():
        for (d, f, pos) in plist:
            terms.append(th)
            docs.append(d)
            freqs.append(f)
            pos_chunks.append(np.asarray(pos, dtype=np.int32))
    pos_off = np.zeros(len(freqs), dtype=np.int64)
    if len(freqs) > 1:
        pos_off[1:] = np.cumsum([len(p) for p in pos_chunks[:-1]], dtype=np.int64)
    positions = (
        np.concatenate(pos_chunks) if pos_chunks else np.zeros(0, np.int32)
    )
    return (
        np.asarray(terms, dtype=np.int64),
        np.asarray(docs, dtype=np.int32),
        np.asarray(freqs, dtype=np.int32),
        pos_off,
        positions.astype(np.int32, copy=False),
    )


def build_segment(
    name: str,
    base_doc: int,
    buffer: Dict[int, List],  # term -> [(doc_local, freq, positions)]
    doc_lens: Sequence[int],
    doc_values: Dict[str, np.ndarray],
    live: Optional[np.ndarray] = None,
) -> Segment:
    """Dict-buffer entry point over ``build_segment_columnar``."""
    cols = _columns_from_buffer(buffer)
    return build_segment_columnar(
        name, base_doc, *cols, doc_lens=doc_lens, doc_values=doc_values, live=live
    )


def merge_segments(name: str, base_doc: int, segments: Sequence[Segment]) -> Segment:
    """Tiered merge: concatenate member posting columns, remap doc ids with
    one prefix sum over the live masks, drop dead postings, one CSR build."""
    n_segs = len(segments)
    doc_base = np.zeros(n_segs + 1, dtype=np.int64)
    doc_base[1:] = np.cumsum([s.n_docs for s in segments])
    pos_base = np.zeros(n_segs + 1, dtype=np.int64)
    pos_base[1:] = np.cumsum([len(s.positions) for s in segments])

    live_all = np.concatenate([s.live for s in segments])
    new_id = np.cumsum(live_all, dtype=np.int64) - 1

    term_all = np.concatenate(
        [np.repeat(s.term_ids, np.diff(s.postings_offsets)) for s in segments]
    )
    doc_global = np.concatenate(
        [s.postings_docs.astype(np.int64) + doc_base[i] for i, s in enumerate(segments)]
    )
    freq_all = np.concatenate([s.postings_freqs for s in segments])
    pos_off_all = np.concatenate(
        [s.pos_offsets[:-1].astype(np.int64) + pos_base[i] for i, s in enumerate(segments)]
    )
    positions_all = np.concatenate([s.positions for s in segments])

    keep = live_all[doc_global]
    doc_col = new_id[doc_global[keep]].astype(np.int32)

    doc_lens = np.concatenate([s.doc_lens for s in segments])[live_all]
    # doc-values keys may differ across members: a member missing a key
    # contributes zeros, keeping every merged column n_docs long
    dv_specs: Dict[str, tuple] = {}
    for s in segments:
        for k, v in s.doc_values.items():
            dv_specs.setdefault(k, (v.dtype, v.shape[1:]))
    new_dv: Dict[str, List[np.ndarray]] = {}
    for s in segments:
        for k, (dt, tail) in dv_specs.items():
            v = s.doc_values.get(k)
            new_dv.setdefault(k, []).append(
                v[s.live] if v is not None
                else np.zeros((int(s.live.sum()),) + tail, dtype=dt)
            )
    dv = {k: np.concatenate(v) for k, v in new_dv.items()}

    return build_segment_columnar(
        name,
        base_doc,
        term_all[keep],
        doc_col,
        freq_all[keep],
        pos_off_all[keep],
        positions_all,
        doc_lens=doc_lens,
        doc_values=dv,
    )
