"""Layered batched query execution (port of ``repro/core/query``).

  types.py    query dataclasses + TopDocs
  plan.py     batch planner: family grouping + shared padding
  exec.py     eager term executors + the cross-segment top-k merge
  fused.py    the term group through CUDA kernel ``term_topk``
  cache.py    device-resident segment cache shared across Searchers
  profile.py  executor dispatch ledger
"""
