"""The benchmark loads no JAX and nothing of the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), refuses to run without a card or without the program, and
takes a new cell as new files and a new entry."""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "hmm_fasta_viterbi_tpu")


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted((ROOT / "hmmbench").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imported(path) & set(FORBIDDEN), path
    # the port itself is allowed, compared whole: its name only begins with the JAX one's
    assert "hmm_fasta_viterbi_tpu_torch" in _imported(ROOT / "hmmbench/harness.py") | {
        n for p in files for n in _imported(p)}


def test_the_reference_takes_nothing_from_the_program():
    for path in (ROOT / "hmmbench/reference").rglob("*.py"):
        assert "hmm_fasta_viterbi_tpu_torch" not in _imported(path), path
        assert "hmm_fasta_viterbi_tpu_torch" not in path.read_text(), path


_DRY_RUN = """
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from hmmbench import run
from hmmbench.tests.cells import run_tiny, tiny_cell
out = run_tiny(tiny_cell("proteome_scan.pfam24", rows=150), traced=True)
assert out["correct"], out
assert not run.forbidden_modules(), run.forbidden_modules()
assert "hmm_fasta_viterbi_tpu_torch" in sys.modules
print("clean")
"""


def test_a_cpu_dry_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _DRY_RUN.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")


def test_forbidden_names_are_compared_whole(monkeypatch):
    from hmmbench import run

    monkeypatch.setitem(sys.modules, "hmm_fasta_viterbi_tpu_torch_probe", object())
    assert "hmm_fasta_viterbi_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hmm_fasta_viterbi_tpu.probe", object())
    assert "hmm_fasta_viterbi_tpu.probe" in run.forbidden_modules()


def _run(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "hmmbench/run.py", "--workload",
                           "sprot_search.pfam24", "--seed", "3", "--seconds", "1",
                           "--trace", "0", *extra], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_no_card_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hmmbench", tmp_path / "hmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "the program is not in this checkout" in proc.stderr


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """A copy of the benchmark gains a cell (a configuration, a traffic
    mix, a metric, a limit and a ``workloads`` entry) and runs it, with no
    file that was there edited."""
    shutil.copytree(ROOT / "hmmbench", tmp_path / "hmmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "data").symlink_to(ROOT / "data")
    before = {p: p.read_bytes() for p in (tmp_path / "hmmbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "hmmbench/configs/hmmsearch_sprot.json").read_text())
    config.update(name="tiny_db", rows=120, library=["100", "200"], length_max=300,
                  planted_share=0.02)
    (tmp_path / "hmmbench/configs/tiny_db.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "hmmbench/traffic/pfam24.json").read_text())
    traffic["check_queries"] = 1
    (tmp_path / "hmmbench/traffic/pairs.json").write_text(json.dumps(traffic))
    (tmp_path / "hmmbench/limits/tiny.pairs.json").write_text(
        (ROOT / "hmmbench/limits/sprot_search.pfam24.json").read_text())
    (tmp_path / "hmmbench/metrics/queries_done.py").write_text(
        "def read(w):\n    return float(w.queries)\n")
    bench["configs"].append({"name": "tiny_db", "source": "a test", "file":
                             "hmmbench/configs/tiny_db.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny_db", "traffic": "pairs",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "queries_done", "unit": "queries", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["tiny.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = f"""
import sys, time, json
sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {str(ROOT)!r})
import torch; torch.set_num_threads(1)
from hmmbench import harness
assert harness.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
cell = harness.load_cell("tiny.pairs")
out = harness.run(cell, 8, 0.5, False, "cpu", time.perf_counter())
print(json.dumps({{"correct": out["correct"], "metrics": sorted(out["metrics"])}}))
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] and "queries_done" in got["metrics"] and "gcups" in got["metrics"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


@pytest.mark.card
def test_the_check_on_the_card(card):
    """On the card at a tiny size: a sound run is correct, the program's
    bf16 prefilters are not."""
    from .cells import run_tiny, tiny_cell

    assert run_tiny(tiny_cell(), device=card)["correct"]
    assert not run_tiny(tiny_cell(), device=card,
                        options={"fast_msv": True, "fast_viterbi": True})["correct"]
