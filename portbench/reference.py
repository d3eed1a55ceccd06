"""The plain reference of the search configurations: Lucene's semantics
worked out again from the generated documents, in float64 PyTorch on the
device, with nothing of the program.

Each document's body tokens give its postings (a doc id per distinct
term, with the term's count); its length is its body and title tokens.
Statistics are the visible snapshot's: ``n_vis`` documents (the deleted
ones included, as unmerged segments keep them), their tokens, and each
term's documents among them.  BM25 has k1 = 0.9, b = 0.4 and idf = log(1
+ (n - df + 0.5) / (df + 0.5)).  Families:

  term, bool   BM25 of the terms summed per doc; AND wants every term, OR one
  sort         the matching docs by the doc value rounded to float32, desc
  range        score 1 for ``lo <= dv <= hi``
  facet        counts per doc-value bin of the matching docs
  vector       dot or cosine similarity of every live doc (0 without a vector)
  hybrid       alpha * s / (s + 1) + (1 - alpha) * c' with c' = c / (1 + |c|)
               (dot) or (c + 1) / 2 (cosine), over every live doc

Hits are live docs below ``n_vis``; a result is the top k by score desc,
doc id asc.  ``control=True`` computes the same in the nearest precisions
below the configuration's float32: similarities from TF32-rounded vectors
accumulated in float32, BM25, sort keys and facet counts in bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

K1, B = 0.9, 0.4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    to even), as the tensor cores take them."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class SearchReference:
    """Answers of a wave of queries of one family over the first ``n_vis``
    documents of ``corpus``.  ``deleted`` is the delete the configuration
    made: (token id, the docs it reached)."""

    def __init__(self, corpus, deleted: tuple, device, control: bool = False) -> None:
        self.device = torch.device(device)
        self.control = control
        dev = self.device
        n = corpus.n_docs
        self.n_docs = n
        tok = torch.from_numpy(corpus.tokens).to(dev).long()
        doc = torch.repeat_interleave(torch.arange(n, device=dev),
                                      torch.from_numpy(corpus.lens).to(dev))
        key, tf = torch.unique_consecutive(torch.sort(tok * n + doc).values,
                                           return_counts=True)
        del tok, doc
        term = key // n
        self.post_doc = key % n
        self.post_tf = tf.double()
        self.term_ptr = torch.searchsorted(term, torch.arange(corpus.vocab + 1, device=dev))
        self.dl_cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                                 torch.from_numpy(corpus.doc_lens()).to(dev).double().cumsum(0)])
        self.dl = torch.from_numpy(corpus.doc_lens()).to(dev).double()
        dead_id, reached = deleted
        self.live = torch.ones(n, dtype=torch.bool, device=dev)
        if dead_id is not None:
            d, _ = self.postings(dead_id, reached)
            self.live[d] = False
        self.dv = {name: torch.from_numpy(col).to(dev) for name, col in corpus.dv.items()}
        self.term_ids = {w: i for i, w in enumerate(corpus.words)}
        self.vectors = None
        if corpus.dim:
            v = torch.from_numpy(corpus.vectors).to(dev)
            v = v * torch.from_numpy(corpus.has_vec).to(dev)[:, None]
            self.vectors = tf32_round(v) if control else v.double()

    # -- postings and statistics --------------------------------------------
    def postings(self, term_id: int, n_vis: int):
        lo, hi = int(self.term_ptr[term_id]), int(self.term_ptr[term_id + 1])
        docs = self.post_doc[lo:hi]
        m = int(torch.searchsorted(docs, torch.tensor([n_vis], device=docs.device)))
        return docs[:m], self.post_tf[lo:lo + m]

    def df(self, token: str, n_vis: int) -> int:
        """Docs below ``n_vis`` whose body holds ``token``."""
        t = self.term_ids.get(token)
        return 0 if t is None else len(self.postings(t, n_vis)[0])

    def bm25(self, token: str, n_vis: int):
        """(N,) BM25 of ``token`` over docs below ``n_vis`` (0 elsewhere)
        and the bool mask of docs holding it."""
        t = self.term_ids.get(token)
        dense = torch.zeros(n_vis, dtype=torch.float64, device=self.device)
        has = torch.zeros(n_vis, dtype=torch.bool, device=self.device)
        if t is None:
            return dense, has
        docs, tf = self.postings(t, n_vis)
        df = len(docs)
        idf = np.log(1.0 + (n_vis - df + 0.5) / (df + 0.5))
        avgdl = float(self.dl_cum[n_vis]) / n_vis
        dl = self.dl[docs]
        if self.control:
            f = lambda x: torch.tensor(x, dtype=torch.float32, device=self.device)  # noqa: E731
            tf32, dl32 = tf.float(), dl.float()
            s = f(idf) * (tf32 * (f(K1) + 1)) / (tf32 + f(K1) * ((1 - f(B)) + f(B) * dl32 / f(avgdl)))
            s = s.to(torch.bfloat16).double()
        else:
            s = idf * (tf * (K1 + 1)) / (tf + K1 * (1 - B + B * dl / avgdl))
        dense[docs] = s
        has[docs] = True
        return dense, has

    def _sum(self, a, b):
        if self.control:
            return (a.to(torch.bfloat16) + b.to(torch.bfloat16)).double()
        return a + b

    def sims(self, qs: np.ndarray, n_vis: int, cosine: bool):
        """(B, N) similarities of the query rows ``qs`` with docs below
        ``n_vis``."""
        v = self.vectors[:n_vis]
        if self.control:
            q = tf32_round(torch.from_numpy(qs).to(self.device))
            s = (q @ v.t()).double()
            if cosine:
                den = (q.norm(dim=1)[:, None] * v.norm(dim=1)[None, :]).double()
                s = torch.where(den > 0, s / den, 0.0)
            return s
        q = torch.from_numpy(qs).to(self.device).double()
        s = q @ v.t()
        if cosine:
            den = q.norm(dim=1)[:, None] * v.norm(dim=1)[None, :]
            s = torch.where(den > 0, s / den, 0.0)
        return s

    # -- one wave -----------------------------------------------------------
    def wave(self, queries: Sequence[dict], n_vis: int) -> Dict:
        """{"kind", "dense" (B, N) float64 scores with -inf off the hits (a
        facet wave: (B, bins) counts), "totals" (B,)} of a wave of plain
        queries (``tasks``) of one family."""
        live = self.live[:n_vis]
        fam = queries[0]["family"]
        if fam in ("vector", "hybrid"):
            cosine = queries[0]["metric"] == "cosine"
            sims = self.sims(np.stack([q["vector"] for q in queries]), n_vis, cosine)
            if fam == "hybrid":
                for i, q in enumerate(queries):
                    s, _ = self.bm25(q["tokens"][0], n_vis)
                    c = (sims[i] + 1.0) * 0.5 if cosine else sims[i] / (1.0 + sims[i].abs())
                    sims[i] = q["alpha"] * (s / (s + 1.0)) + (1.0 - q["alpha"]) * c
            return {"kind": "scored", "dense": torch.where(live[None], sims, -torch.inf),
                    "totals": [int(live.sum())] * len(queries)}
        rows: List[torch.Tensor] = []
        totals: List[int] = []
        kind = {"term": "scored", "bool": "scored"}.get(fam, fam)
        for q in queries:
            if fam in ("term", "bool"):
                parts = [self.bm25(t, n_vis) for t in q["tokens"]]
                s, has = parts[0]
                for s2, h2 in parts[1:]:
                    s = self._sum(s, s2)
                    has = (has | h2) if q.get("mode") == "or" else (has & h2)
            elif fam == "sort":
                has = self.bm25(q["tokens"][0], n_vis)[1]
                key = self.dv[q["field"]][:n_vis].float()
                s = (key.to(torch.bfloat16) if self.control else key).double()
            elif fam == "range":
                dv = self.dv[q["field"]][:n_vis]
                has = (dv >= q["lo"]) & (dv <= q["hi"])
                s = torch.ones(n_vis, dtype=torch.float64, device=self.device)
            elif fam == "facet":
                has = self.bm25(q["tokens"][0], n_vis)[1] if q["tokens"] else live
                bins = self.dv[q["field"]][:n_vis].long().clamp(min=0)
                ok = has & live & (bins < q["n_bins"])
                c = torch.bincount(bins[ok], minlength=q["n_bins"]).double()
                rows.append(c.to(torch.bfloat16).double() if self.control else c)
                totals.append(int((has & live).sum()))
                continue
            else:
                raise ValueError(f"no reference for family {fam!r}")
            hit = has & live
            rows.append(torch.where(hit, s, -torch.inf))
            totals.append(int(hit.sum()))
        return {"kind": kind, "dense": torch.stack(rows), "totals": totals}
