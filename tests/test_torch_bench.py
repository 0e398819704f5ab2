"""The port's bench (``python -m hmm_fasta_viterbi_tpu_torch.bench``) held
against the JAX bench (``bench.py`` and ``hmm_fasta_viterbi_tpu/bench/
harness.py``) on the CPU at a small size: the same random tokens, result
fields and JSON line, the same cell counts row for row, ``msv_scores``
bit for bit with ``msv_xla`` and ``msv_pallas``, and no caught failure."""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hmm_fasta_viterbi_tpu as jx
from hmm_fasta_viterbi_tpu.bench import harness as jax_harness
from hmm_fasta_viterbi_tpu.models.p7 import P7Profile as JaxP7Profile
from hmm_fasta_viterbi_tpu.ops.pallas_msv import msv_pallas
from hmm_fasta_viterbi_tpu.ops.xla_scan import msv_xla
from hmm_fasta_viterbi_tpu.pipeline import MSVScanner as JaxScanner
from hmm_fasta_viterbi_tpu_torch import MSVProfile, parse_hmm
from hmm_fasta_viterbi_tpu_torch.bench import harness, rows
from hmm_fasta_viterbi_tpu_torch.bench.__main__ import REPO, main
from hmm_fasta_viterbi_tpu_torch.pipeline import MSVScanner, msv_scores

MSV_TOL = 1e-4  # the JAX suite's MSV tolerance; 0.0 expected
BATCH, SEQ_LEN = 8, 64
# the posterior rows' shape, cut for the CPU run of every row (the
# constants themselves are checked against bench.py's)
POST_BATCH, POST_LEN = 4, 64
# every switch of the bench off: the headline and the reference pass remain
ALL_OFF = ["--no-sweep", "--no-stages", "--no-filter", "--no-m2405", "--no-cascade",
           "--no-stream", "--no-oracle"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite's workers share the cores, and the plain
    versions' many small ops stall when their thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_msv(profile_dir, stem):
    return jx.MSVProfile.from_profile(jx.parse_hmm(profile_dir / f"{stem}.hmm"))


def _port_msv(profile_dir, stem):
    return MSVProfile.from_profile(parse_hmm(profile_dir / f"{stem}.hmm"))


@pytest.mark.parametrize("batch,seq_len,seed", [(1, 1, 0), (8, 64, 0), (3, 3500, 0),
                                                (1024, 1024, 2), (5, 7, 3)])
def test_random_tokens_equal_jax(batch, seq_len, seed):
    got = harness.random_tokens(batch, seq_len, seed=seed)
    want = jax_harness.random_tokens(batch, seq_len, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _results(names, cls):
    """One result a row name, the same numbers under either harness's class."""
    return [cls(name=n, gcups=12345.678 + k, seconds=0.0125 + k, cells=80_220_000_000 + k,
                batch=16384, seq_len=3500, model_length=1401, repetitions=3,
                rep_seconds=[0.0125 + k, 0.0126 + k, 0.01271234567 + k])
            for k, n in enumerate(names)]


def test_bench_result_fields_and_keys_are_jax():
    assert harness.BASELINE_GCUPS == jax_harness.BASELINE_GCUPS
    assert ([f.name for f in dataclasses.fields(harness.BenchResult)]
            == [f.name for f in dataclasses.fields(jax_harness.BenchResult)])
    got, = _results(["headline_1400_cuda"], harness.BenchResult)
    want, = _results(["headline_1400_cuda"], jax_harness.BenchResult)
    assert got.to_json() == want.to_json()
    assert list(got.to_json()) == list(want.to_json())


def _row_names(profile_dir, suffix):
    """bench.py's row names, in its order, under ``suffix``."""
    stems = sorted((int(p.stem) for p in profile_dir.glob("*.hmm")))
    return ([f"sweep24_{suffix}"] + [f"sweep_p{s}_{suffix}" for s in stems]
            + [f"{n}_{suffix}" for n in (
                "sweep24_filter", "filter_1400", "headline_2405", "viterbi_1400", "forward_1400",
                "viterbi_filter_1400", "cascade_1400", "cascade_fast_1400", "posterior_1400",
                "posterior_mask_1400", "stream_search_1400")]
            + ["oracle_msv_numpy", f"ref_1400_b3_{suffix}", f"e2e_1400_{suffix}"])


def test_emit_json_line_is_jax_line(profile_dir, tmp_path):
    """The same results give JAX's payload and detail, env aside; the line
    with every row (the 24 sweep rows among them) and the default detail
    path stays under the 1900 characters the JAX bench test allows."""
    names = _row_names(profile_dir, "cuda")
    assert len(names) == 39
    lines = {}
    for label, mod, kwargs in (("port", harness, {"device": "cpu"}), ("jax", jax_harness, {})):
        primary, *extras = _results(["headline_1400_cuda", *names], mod.BenchResult)
        path = tmp_path / f"{label}.json"
        payload = json.loads(mod.emit_json_line(primary, extras, detail_path=str(path),
                                                **kwargs))
        assert payload.pop("detail_file") == str(path)
        detail = json.loads(path.read_text())
        lines[label] = (payload, detail, detail.pop("env"))
    assert lines["port"][:2] == lines["jax"][:2]
    assert list(lines["port"][0]) == list(lines["jax"][0])
    env = lines["port"][2]
    assert env["platform"] == "cpu" and env["device_kind"] == "cpu"
    assert env["torch_version"] == torch.__version__ and "timestamp_utc" in env
    # the line as the bench prints it, its detail file at the default path
    # (written here under tmp_path: the length counts the default's)
    primary, *extras = _results(["headline_1400_cuda", *names], harness.BenchResult)
    path = tmp_path / "bench_detail_torch.json"
    line = harness.emit_json_line(primary, extras, detail_path=str(path), device="cpu")
    assert len(line) - len(str(path)) + len(str(REPO / path.name)) < 1900
    no_file = json.loads(harness.emit_json_line(primary, extras, device="cpu"))
    assert no_file["detail"]["errors"] == [] and no_file["errors"] == []


def test_bench_staged_and_profile_agree_with_jax(profile_dir):
    """On the same ragged batch, the port's bench_staged (a CPU scanner) and
    bench_profile (msv_scores) count JAX's cells, batch, seq_len and
    model_length (JAX: MSVScanner(backend="xla"), msv_xla)."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 20, size=(6, 90)).astype(np.int32)
    lengths = np.array([0, 1, 33, 64, 89, 17], dtype=np.int32)
    jprof, prof = _jax_msv(profile_dir, "100"), _port_msv(profile_dir, "100")
    jscan = JaxScanner(backend="xla")
    fields = ("cells", "batch", "seq_len", "model_length", "repetitions")
    got = harness.bench_staged("s", MSVScanner(device="cpu"), prof,
                               MSVScanner(device="cpu").stage(tokens, lengths), 2)
    want = jax_harness.bench_staged("s", jscan, jprof, jscan.stage(tokens, lengths), 2)
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.cells == int(lengths.sum()) * 100 and len(got.rep_seconds) == 2
    got = harness.bench_profile("p", prof, lambda p, t, l: msv_scores(p, t, l, device="cpu"),
                                tokens, lengths, 2)
    want = jax_harness.bench_profile("p", jprof, msv_xla, tokens, lengths, 2)
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.gcups == got.cells / got.seconds / 1e9 and got.seconds == min(got.rep_seconds)


@pytest.mark.parametrize("stem,reference", [("100", "xla"), ("1400", "xla"),
                                            ("100", "pallas_interpret")])
def test_msv_scores_equal_jax(profile_dir, stem, reference):
    """msv_scores on the CPU (the plain version of B1) equals JAX's msv_xla
    and msv_pallas(interpret=True) bit for bit on a ragged batch."""
    rng = np.random.default_rng(11)
    lengths = np.array([0, 1, 31, 32, 33, 100, 257, 300], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(len(lengths), 300)).astype(np.int32)
    got = msv_scores(_port_msv(profile_dir, stem), tokens, lengths, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(lengths),)
    fn = msv_xla if reference == "xla" else lambda *a: msv_pallas(*a, interpret=True)
    want = np.asarray(fn(_jax_msv(profile_dir, stem), tokens, lengths))
    got = got.numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite) and not finite[0]
    err = float(np.max(np.abs(got[finite] - want[finite])))
    assert err <= MSV_TOL and err == 0.0


@pytest.fixture(scope="module")
def every_row(tmp_path_factory):
    """One in-process CPU run of every row (``--e2e`` included) at BATCH x
    SEQ_LEN, the posterior rows at POST_BATCH x POST_LEN: (the JSON line,
    the detail file's results by name)."""
    detail = tmp_path_factory.mktemp("bench") / "detail.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rows, "POSTERIOR_BATCH", POST_BATCH)
        mp.setattr(rows, "POSTERIOR_LEN", POST_LEN)
        out = _capture(["--device", "cpu", "--quick", "--batch", str(BATCH), "--seq-len",
                        str(SEQ_LEN), "--e2e", "--detail-file", str(detail)])
    data = json.loads(detail.read_text())
    results = {r["name"]: r for r in [data["primary"], *data["extras"]]}
    return json.loads(out.splitlines()[-1]), results, data


def _capture(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_every_row_runs_in_bench_py_order(every_row, profile_dir):
    """Every bench.py row, in bench.py's order, under ``_cpu``; the line's
    keys are bench.py's and the detail's env names the CPU."""
    payload, _, data = every_row
    assert list(payload) == ["metric", "value", "unit", "vs_baseline", "extras", "errors",
                             "detail_file"]
    assert payload["metric"] == "GCUPS_M1400" and payload["value"] > 0
    assert payload["errors"] == [] and data["errors"] == []
    assert list(payload["extras"]) == _row_names(profile_dir, "cpu")
    assert data["primary"]["name"] == "headline_1400_cpu"
    assert data["env"]["platform"] == "cpu"


@functools.lru_cache(maxsize=None)
def _jax_m(profile_dir, stem="1400"):
    return _jax_msv(profile_dir, stem).model_length


# row: (bench.py lines, (cells, batch, seq_len, model_length) by bench.py's
# formula at BATCH x SEQ_LEN from the JAX package's profiles)
def _expected(row, d):
    m = _jax_m(d)
    p7_m = JaxP7Profile.from_profile(jx.parse_hmm(d / "1400.hmm")).model_length
    sweep = sum(BATCH * SEQ_LEN * (_jax_m(d, p.stem) - 1) for p in d.glob("*.hmm"))
    return {
        # harness.py:103-104, bench.py:256-258: staged headline batch
        "headline_1400": (BATCH * SEQ_LEN * (m - 1), BATCH, SEQ_LEN, m),
        # bench.py:285, 298-302: min(batch, 8192) rows x 24 profiles
        "sweep24": (sweep, min(BATCH, 8192), SEQ_LEN, 0),
        "sweep24_filter": (sweep, min(BATCH, 8192), SEQ_LEN, 0),
        # bench.py:371-377: the headline batch
        "filter_1400": (BATCH * SEQ_LEN * (m - 1), BATCH, SEQ_LEN, m),
        # bench.py:391-394: max(128, batch // 2) rows of the batch
        "headline_2405": (min(BATCH, max(128, BATCH // 2)) * SEQ_LEN * 2405,
                          min(BATCH, max(128, BATCH // 2)), SEQ_LEN, _jax_m(d, "2405")),
        # bench.py:413-433: max(128, batch // 4) rows of the batch, P7 profile
        **{f"{s}_1400": (min(BATCH, max(128, BATCH // 4)) * SEQ_LEN * (p7_m - 1),
                         min(BATCH, max(128, BATCH // 4)), SEQ_LEN, p7_m)
           for s in ("viterbi", "forward", "viterbi_filter")},
        # bench.py:454, 462-464: min(batch, 4096) rows, MSV cells
        **{c: (min(BATCH, 4096) * SEQ_LEN * (m - 1), min(BATCH, 4096), SEQ_LEN, m)
           for c in ("cascade_1400", "cascade_fast_1400")},
        # bench.py:521, 537: pb x pl_len (here the cut shape)
        **{p: (POST_BATCH * POST_LEN * (p7_m - 1), POST_BATCH, POST_LEN, p7_m)
           for p in ("posterior_1400", "posterior_mask_1400")},
        # bench.py:610-611 (--quick: 64 sequences, batches of 16), cells
        # summed by cli.py:322-324
        "stream_search_1400": (64 * SEQ_LEN * (m - 1), 16, SEQ_LEN, m),
        # bench.py:690-697: 2 sequences of seq_len
        "oracle_msv_numpy": (2 * SEQ_LEN * (m - 1), 2, SEQ_LEN, m),
        # bench.py:717-728: 3 x 3500
        "ref_1400_b3": (3 * 3500 * (m - 1), 3, 3500, m),
        # bench.py:739-743: the headline batch end to end
        "e2e_1400": (BATCH * SEQ_LEN * (m - 1), BATCH, SEQ_LEN, m),
    }[row]


@pytest.mark.parametrize("row", [
    "headline_1400", "sweep24", "sweep_pXXX", "sweep24_filter", "filter_1400", "headline_2405",
    "viterbi_1400", "forward_1400", "viterbi_filter_1400", "cascade_1400", "cascade_fast_1400",
    "posterior_1400", "posterior_mask_1400", "stream_search_1400", "oracle_msv_numpy",
    "ref_1400_b3", "e2e_1400",
])
def test_row_cells_are_bench_py_cells(every_row, profile_dir, row):
    _, results, _ = every_row
    fields = ("cells", "batch", "seq_len", "model_length")
    if row == "sweep_pXXX":  # bench.py:325-329: each profile on the sweep's rows
        for path in profile_dir.glob("*.hmm"):
            m = _jax_m(profile_dir, path.stem)
            r = results[f"sweep_p{m - 1}_cpu"]
            assert [r[f] for f in fields] == [BATCH * SEQ_LEN * (m - 1), BATCH, SEQ_LEN, m]
        return
    r = results[row if row == "oracle_msv_numpy" else f"{row}_cpu"]
    assert tuple(r[f] for f in fields) == _expected(row, profile_dir)
    assert r["gcups"] == pytest.approx(r["cells"] / r["seconds"] / 1e9)
    # the detail rounds rep_seconds to 6 digits (harness.py:50-53)
    assert r["seconds"] == pytest.approx(min(r["rep_seconds"] or [r["seconds"]]), abs=1e-6)
    if row == "posterior_1400":  # the cut shape stands in for bench.py:521-522's
        assert (rows.POSTERIOR_BATCH, rows.POSTERIOR_LEN, rows.POSTERIOR_SEED) == (1024, 1024, 2)


def test_cli_quick_on_the_cpu(tmp_path):
    """``python -m hmm_fasta_viterbi_tpu_torch.bench --device cpu --quick``
    with the slow rows off ends in bench.py's line: GCUPS_M1400, a value,
    no errors, rows named ``_cpu``, the detail in the named file."""
    detail = tmp_path / "detail.json"
    proc = subprocess.run(
        [sys.executable, "-m", "hmm_fasta_viterbi_tpu_torch.bench", "--device", "cpu", "--quick",
         "--batch", str(BATCH), "--seq-len", str(SEQ_LEN), *ALL_OFF,
         "--detail-file", str(detail)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"},  # one torch thread, as in-process
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    payload = json.loads(proc.stdout.splitlines()[-1])
    assert payload["metric"] == "GCUPS_M1400" and payload["unit"] == "GCUPS"
    assert payload["value"] > 0 and payload["errors"] == []
    assert list(payload["extras"]) == ["ref_1400_b3_cpu"]
    assert payload["detail_file"] == str(detail)
    assert json.loads(detail.read_text())["primary"]["rep_seconds"]
    assert "# headline:" in proc.stderr


def test_a_failing_row_fails_the_bench(monkeypatch, capsys, tmp_path):
    """No row's failure is caught: main raises and prints no JSON line."""

    def broken(bench):
        raise RuntimeError("the oracle row broke")

    monkeypatch.setattr(rows, "oracle", broken)
    argv = ["--device", "cpu", "--quick", "--batch", str(BATCH), "--seq-len", str(SEQ_LEN),
            *[a for a in ALL_OFF if a != "--no-oracle"], "--detail-file",
            str(tmp_path / "d.json")]
    with pytest.raises(RuntimeError, match="the oracle row broke"):
        main(argv)
    assert "{" not in capsys.readouterr().out
    assert not (tmp_path / "d.json").exists()


def test_cuda_bench_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--quick", "--batch", str(BATCH), "--seq-len", str(SEQ_LEN)])
    assert "{" not in capsys.readouterr().out
