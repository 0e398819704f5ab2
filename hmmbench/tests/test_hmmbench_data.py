"""The generators, the cell arithmetic and the files a cell is made of."""

import json
import statistics

import numpy as np
import pytest

from hmmbench import check, harness, work
from hmmbench.reference import hmm as hmm_mod
from hmmbench.traffic import emit, generator

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _config(rows=200, share=0.02):
    config = json.loads((ROOT / "hmmbench/configs/hmmsearch_sprot.json").read_text())
    config.update(rows=rows, library=["100", "200"], length_max=400, planted_share=share)
    return config


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3, -9])
def test_database_repeats_per_seed(seed):
    config = _config()
    lib = generator.parse_library(config, ROOT)
    a = generator.make_database(config, lib, seed, "cpu")
    b = generator.make_database(config, lib, seed, "cpu")
    c = generator.make_database(config, lib, seed + 1, "cpu")
    assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.lengths, b.lengths)
    assert np.array_equal(a.family, b.family)
    assert not np.array_equal(a.tokens, c.tokens)
    # another seed holds the same rows in another order
    key = lambda db: sorted(map(bytes, db.tokens))  # noqa: E731
    assert key(a) == key(c)
    assert a.tokens.dtype == np.int8 and a.tokens.max() < 20 and a.tokens.min() >= 0
    for r in range(len(a.lengths)):  # nothing past a row's length
        assert not a.tokens[r, a.lengths[r]:].any()
    assert (a.family >= 0).sum() == 2 * round(0.02 * 200)


def test_every_seed_holds_the_same_sizes():
    config = _config(rows=1000, share=0.0)
    lib = generator.parse_library(config, ROOT)
    sizes = [np.sort(generator.make_database(config, lib, s, "cpu").lengths) for s in (1, 2)]
    assert np.array_equal(sizes[0], sizes[1])
    fixed = generator.fixed_lengths(570000, 300.0, 0.61, 10, 4096)
    assert fixed.min() >= 10 and fixed.max() == 4096
    assert 355 < fixed.mean() < 368  # Swiss-Prot's mean length, about 362


def test_composition_is_drawn():
    config = _config(rows=2000, share=0.0)
    db = generator.make_database(config, generator.parse_library(config, ROOT), 3, "cpu")
    counts = np.bincount(np.concatenate([db.tokens[r, :n] for r, n in enumerate(db.lengths)]),
                         minlength=20)
    want = generator.composition(config)
    assert np.allclose(counts / counts.sum(), want, atol=0.004)


def test_emitted_domains_repeat_and_follow_the_model():
    h = hmm_mod.parse(ROOT / "data/profile_HMMs/100.hmm", star_as_zero=True)
    a = emit.emit_domains(h, 64, np.random.default_rng(4), 4096)
    b = emit.emit_domains(h, 64, np.random.default_rng(4), 4096)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    lengths = np.array([len(x) for x in a])
    assert 70 < lengths.mean() < 140  # LENG 100, give or take the inserts and deletes
    # the residues follow the model's match emissions, averaged over its nodes
    got = np.bincount(np.concatenate(a), minlength=20) / sum(lengths)
    assert np.allclose(got, h.match[1:].mean(axis=0), atol=0.015)
    assert all(len(x) <= 50 for x in emit.emit_domains(h, 8, np.random.default_rng(1), 50))


def test_query_schedule_repeats_per_seed_in_rounds():
    one = generator.load_traffic("pfam24")
    a = [q for _, q in zip(range(72), generator.queries(one, 24, 11))]
    b = [q for _, q in zip(range(72), generator.queries(one, 24, 11))]
    c = [q for _, q in zip(range(72), generator.queries(one, 24, 12))]
    assert a == b and a != c and all(len(q) == 1 for q in a)
    for start in (0, 24, 48):  # every round holds each profile once, in its own order
        assert sorted(p for q in a[start:start + 24] for p in q) == list(range(24))
    assert a[24:48] != a[:24] and a[48:] != a[24:48]
    every = generator.load_traffic("pfam24_all")
    gen = generator.queries(every, 24, 11)
    q = next(gen)
    assert sorted(q) == list(range(24)) and next(gen) == q  # hmmscan: one library order
    with pytest.raises(ValueError, match="rounds"):
        next(generator.queries(dict(one, rounds="cycled"), 24, 11))


def test_the_proteome_holds_its_longest_entries():
    config = json.loads((ROOT / "hmmbench/configs/pfam_scan_proteome.json").read_text())
    lengths = generator.config_lengths(config)
    assert np.all(np.diff(lengths) >= 0) and len(lengths) == config["rows"]
    assert list(lengths[-4:]) == [7968, 8797, 14507, 34350]  # obscurin ... titin
    assert lengths[-5] < 7968 and lengths.max() <= config["length_max"]
    published = config["published"]
    assert lengths.max() == published["longest_entry"]
    assert abs(lengths.sum() / published["residues"] - 1) < 0.01
    assert abs(lengths.mean() / published["mean_length"] - 1) < 0.01
    sprot = json.loads((ROOT / "hmmbench/configs/hmmsearch_sprot.json").read_text())
    assert np.array_equal(generator.config_lengths(sprot), generator.fixed_lengths(
        570000, 300.0, 0.61, 10, 4096))  # no named entries: the fit alone


def test_cell_arithmetic_matches_a_hand_count():
    assert work.cells(1000, 100) == 100_000
    ops, nbytes = work.stage_work("msv", rows=10, residues=1000, leng=100)
    assert ops == 3 * 100_000
    assert nbytes == 1000 + 16 * 10 + 4 * 20 * 100
    ops, nbytes = work.stage_work("forward", rows=2, residues=50, leng=10)
    assert ops == 16 * 500 and nbytes == 50 + 24 * 2 + 4 * 47 * 10
    assert work.least_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)

    lat = [0.010 * (k + 1) for k in range(40)]
    w = harness.Window(seconds=2.0, latencies=lat, msv_cells=4_000_000_000,
                       phase_seconds={"msv": 0.8, "viterbi": 0.3, "forward": 0.1}, setup_s=7.5,
                       rows={"msv": 1000, "viterbi": 25, "forward": 5},
                       stage_work={"msv": [6e9, 1e6], "viterbi": [1e9, 1e4], "forward": [1e9, 1e4]},
                       trace=None)
    assert harness.reader("gcups")(w) == pytest.approx(2.0)
    assert harness.reader("query_p95_ms")(w) == pytest.approx(
        statistics.quantiles(lat, n=20)[18] * 1e3)
    assert harness.reader("setup_s")(w) == 7.5
    assert harness.reader("msv_stage_ms")(w) == pytest.approx(20.0)
    assert harness.reader("p7_stage_ms")(w) == pytest.approx(10.0)
    assert harness.reader("msv_pass_pct")(w) == pytest.approx(2.5)
    for name in ("msv_roofline", "p7_roofline", "device_idle_pct", "search_mfu"):
        assert harness.reader(name)(w) is None  # nothing traced, nothing read

    from hmmbench.trace import Summary
    w.trace = Summary(window_s=2.0, busy_s=1.5,
                      kernels=[("void msv_kernel<32, 44>(MsvArgs)", 0.5),
                               ("void viterbi_kernel<1>(ViterbiArgs)", 0.25),
                               ("forward_cluster_kernel", 0.25),
                               ("at::native::index_kernel", 1.0)],
                      device_ops=[], idle_gaps=[])
    assert harness.reader("msv_roofline")(w) == pytest.approx(100 * 6e9 / 67e12 / 0.5)
    assert harness.reader("p7_roofline")(w) == pytest.approx(100 * 2e9 / 67e12 / 0.5)
    assert harness.reader("device_idle_pct")(w) == pytest.approx(25.0)
    assert harness.reader("search_mfu")(w) == pytest.approx(100 * 8e9 / (2.0 * 67e12))


def test_trace_summary_counts_the_union_and_names_the_gaps():
    from hmmbench import trace

    ev = [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": trace.QUERY, "ts": 0, "dur": 90},
        {"cat": "user_annotation", "name": "msv", "ts": 0, "dur": 40},
        {"cat": "kernel", "name": "msv_kernel", "ts": 5, "dur": 20},
        {"cat": "kernel", "name": "msv_kernel", "ts": 15, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 36, "dur": 4},
        {"cat": "cpu_op", "name": "aten::index", "ts": 50, "dur": 30},
        {"cat": "kernel", "name": "viterbi_kernel", "ts": 80, "dur": 10},
    ]
    s = trace.summarize({"traceEvents": ev})
    assert s.window_s == pytest.approx(1e-4)
    assert s.busy_s == pytest.approx(44e-6)
    assert s.device_ops[0] == ["msv_kernel", pytest.approx(40e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["between stages/aten::index"] == pytest.approx(40e-6)
    assert gaps["msv/host"] == pytest.approx(6e-6)  # 0-5 and 35-36
    assert gaps["between queries/host"] == pytest.approx(10e-6)


def test_every_file_of_a_cell_loads_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        harness.verify_library(cell.config)
        assert set(check.load_limits(w["name"])) == set(check.NUMBERS)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]))
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(config["reduced"])
        assert all(k in config for k in c["reduced"])
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (ROOT / "hmmbench/metrics").glob("*.py") if not p.stem.startswith("_")}
    assert names == files


def test_benchmark_json_keeps_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
