"""The benchmark's own files: BENCHMARK.json's names and units, every cell,
mix, limit and metric found by its file name, the whole-name import check,
and the plain reference against a brute-force scan of a tiny corpus."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from portbench import compare, harness
from portbench.corpus import Corpus, word
from portbench.reference import SearchReference
from portbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for key in entry.get("reduced", ()):
        assert NAME.match(key)


LATER = json.loads((Path(__file__).parent / "later_cells.json").read_text())
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_exactly_the_contract_keys(group):
    need, may = KEYS[group]
    for entry in BENCH[group] + LATER.get(group, []):
        assert need <= set(entry) <= need | may, entry["name"]
        if group == "end_to_end":
            assert entry["source"] in ("host_clock", "device_trace")
        elif group == "per_layer":
            assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
            assert "roofline" not in entry["name"] or entry["name"].endswith("_roofline")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = harness.load("configs", cell["config"])
    harness.load("traffic", cell["traffic"])
    limits = harness.load("limits", cell["name"])
    assert cfg["name"] == cell["config"] and cell["chips"] == 1
    assert {"exact_mismatch", "score_err", "rank_gap"} <= set(limits)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / entry["file"]).is_file()
    assert all(key in cfg for key in entry["reduced"])
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric["name"]))
    if metric in BENCH["per_layer"]:
        for cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
            assert metric["moves"] in e2e


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core.engine", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.search"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reproducer", "benchmarks_x"], []),
])
def test_import_check_compares_whole_top_level_names(names, bad):
    assert forbidden_modules(names) == bad


TINY = dict(vocab=300, zipf_a=1.3, mean_len=12, len_sigma=0.5, min_len=4,
            dv_ranges={"month": 12, "dayOfYear": 365, "timestamp": 1 << 30},
            vector_dim=6, vectorless_share=0.2)


def brute(corpus, q, n_vis, dead):
    """Scores of every doc below n_vis, by loops over each doc's tokens."""
    toks = [corpus.tokens[corpus.offsets[d]:corpus.offsets[d + 1]].tolist()
            for d in range(n_vis)]
    dl = corpus.doc_lens()[:n_vis].astype(float)
    avgdl = dl.sum() / n_vis
    ids = {word(i): i for i in range(corpus.vocab)}
    live = [not (d < dead[1] and dead[0] in toks[d]) for d in range(n_vis)]

    def bm25(tok, d):
        df = sum(ids[tok] in t for t in toks)
        tf = toks[d].count(ids[tok])
        idf = np.log(1 + (n_vis - df + 0.5) / (df + 0.5))
        return idf * tf * 1.9 / (tf + 0.9 * (0.6 + 0.4 * dl[d] / avgdl)), tf > 0

    out = np.full(n_vis, -np.inf)
    for d in range(n_vis):
        if not live[d]:
            continue
        if q["family"] == "bool":
            parts = [bm25(t, d) for t in q["tokens"]]
            has = [h for _, h in parts]
            if all(has) if q["mode"] == "and" else any(has):
                out[d] = sum(s for s, _ in parts)
        elif q["family"] == "sort":
            if bm25(q["tokens"][0], d)[1]:
                out[d] = float(np.float32(corpus.dv[q["field"]][d]))
        elif q["family"] == "range":
            if q["lo"] <= corpus.dv[q["field"]][d] <= q["hi"]:
                out[d] = 1.0
        elif q["family"] == "vector":
            v = corpus.vectors[d].astype(float) * corpus.has_vec[d]
            qv = q["vector"].astype(float)
            c = v @ qv
            if q["metric"] == "cosine":
                den = np.linalg.norm(v) * np.linalg.norm(qv)
                c = c / den if den > 0 else 0.0
            out[d] = c
    return out


def test_reference_agrees_with_a_brute_force_scan():
    corpus = Corpus(TINY, 2**31 + 3, 240, "cpu")
    dead = (int(corpus.tokens[corpus.tokens >= 150].min()), 200)
    ref = SearchReference(corpus, dead, "cpu")
    rng = np.random.default_rng(0)
    common = [word(i) for i in (1, 2, 3, 5)]
    queries = [
        {"family": "bool", "mode": "and", "tokens": (common[0], common[1])},
        {"family": "bool", "mode": "or", "tokens": (common[2], common[3])},
        {"family": "sort", "tokens": (common[0],), "field": "timestamp"},
        {"family": "range", "field": "month", "lo": 2, "hi": 5},
        {"family": "vector", "metric": "cosine",
         "vector": rng.standard_normal(6).astype(np.float32)},
    ]
    for q in queries:
        for n_vis in (180, 240):
            wave = ref.wave([q], n_vis)
            want = brute(corpus, q, n_vis, dead)
            got = wave["dense"][0].numpy()
            assert np.array_equal(np.isfinite(got), np.isfinite(want)), q["family"]
            fin = np.isfinite(want)
            assert np.allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12), q["family"]
            assert wave["totals"][0] == int(fin.sum())
            vals, ids = compare.ranked(wave, 10)
            order = sorted(np.nonzero(fin)[0], key=lambda d: (-want[d], d))[:10]
            assert ids[0][np.isfinite(vals[0])].tolist() == order


def test_facet_reference_counts_bins():
    corpus = Corpus(TINY, 7, 120, "cpu")
    ref = SearchReference(corpus, (None, 0), "cpu")
    wave = ref.wave([{"family": "facet", "tokens": (), "field": "month", "n_bins": 12}], 120)
    assert wave["dense"][0].numpy().tolist() == np.bincount(corpus.dv["month"],
                                                            minlength=12).tolist()
