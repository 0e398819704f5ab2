"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names a configuration (``configs/<name>.json``) and a
traffic mix (``traffic/<name>.json``), and each metric it reports is a
reader of its own (``metrics/<metric>.py``, a ``read(window)`` that
returns a number or None). A new cell is a new entry and new files.

The program under test is ``hmm_fasta_viterbi_tpu_torch``, driven through
its public entry points only: ``MSVScanner.stage_bucketed`` in set-up,
``SearchPipeline.search_bucketed`` in the window.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import check, work
from . import trace as trace_mod
from .reference import hmm as hmm_mod
from .traffic import generator

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = json.loads((HERE / "configs" / f"{spec['config']}.json").read_text())
    return Cell(name, config, generator.load_traffic(spec["traffic"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"hmmbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Window:
    """What the metric readers read."""

    seconds: float  # the window by the host clock
    latencies: list  # seconds, one a completed query
    msv_cells: int  # MSV cells of the completed queries
    phase_seconds: dict  # the program's SearchPipeline.phase_totals over the window
    setup_s: float
    stage_work: dict  # {stage: [ops, bytes]} of the window (traced runs)
    rows: dict  # {stage: rows given}, "searched": rows searched (traced runs)
    trace: trace_mod.Summary | None

    @property
    def queries(self) -> int:
        return len(self.latencies)


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def verify_library(config: dict) -> None:
    for path in generator.library_paths(config, ROOT):
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if digest != config["library_sha256"][path.stem]:
            raise RuntimeError(f"{path} is not the profile this configuration was set on")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


class Reservoir:
    """A uniform sample of ``size`` finished queries, drawn from the seed,
    and the latest finished query that holds the library's longest
    profile."""

    def __init__(self, size: int, longest: int, rng: np.random.Generator):
        self.size, self.longest, self.rng = size, longest, rng
        self.kept: list = []
        self.seen = 0
        self.last_longest = None

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            k = int(self.rng.integers(0, self.seen))
            if k < self.size:
                self.kept[k] = item
        if any(c.profile == self.longest for c in item):
            self.last_longest = item

    def sample(self) -> list:
        out = list(self.kept)
        holds = any(c.profile == self.longest for q in out for c in q)
        if self.last_longest is not None and not holds:
            out.append(self.last_longest)
        return [c for query in out for c in query]


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: str, started: float,
        pipeline_options: dict | None = None, control: bool = False) -> dict:
    """Set up, measure ``seconds``, check; the result line's fields, and
    ``numbers`` (the check's readings) and ``limits``. ``pipeline_options``
    go to ``SearchPipeline`` (the program's own control: its bf16
    prefilters); ``control`` also reads the bf16 reference's numbers."""
    import hmm_fasta_viterbi_tpu_torch as port

    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    verify_library(config)
    card = power_limit() if cuda else "cpu"
    paths = generator.library_paths(config, ROOT)
    marks = [("start", time.perf_counter() - started)]
    db = generator.make_database(config, generator.parse_library(config, ROOT), seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("database", time.perf_counter() - started))

    scanner = port.MSVScanner(device=device)
    bucketed = scanner.stage_bucketed(db.tokens, db.lengths)
    marks.append(("staged", time.perf_counter() - started))
    hmms = [port.parse_hmm(p) for p in paths]
    leng = [h.leng for h in hmms]
    pipe = port.SearchPipeline(scanner, **(pipeline_options or {}))
    marks.append(("parsed", time.perf_counter() - started))
    for p in range(len(hmms)):  # warm every profile of the library once
        pipe.search_bucketed(hmms[p], bucketed, db.tokens, db.lengths)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    marks.append(("warm", setup_s))
    log(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.2f}' for k, v in marks)}): "
        f"{len(db.lengths)} rows, {db.residues} residues, {len(bucketed.buckets)} buckets, "
        f"card {card}")

    before = dict(pipe.phase_totals)
    schedule = generator.queries(traffic, len(hmms), seed)
    pool = Reservoir(traffic["check_queries"], int(np.argmax(leng)),
                     np.random.default_rng([generator.seed_bits(seed), 2]))
    latencies, msv_cells, failed = [], 0, 0
    stage_work = {s: [0.0, 0.0] for s in ("msv", "viterbi", "forward")}
    rows_given = {"msv": 0, "viterbi": 0, "forward": 0}
    trace_dir = tempfile.mkdtemp(prefix="hmmbench-trace-") if traced else None
    from hmm_fasta_viterbi_tpu_torch.runtime.profiling import device_trace

    with device_trace(trace_dir, device), torch.profiler.record_function(trace_mod.WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            query = next(schedule)
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(trace_mod.QUERY):
                    done = [check.Checked(p, pipe.search_bucketed(hmms[p], bucketed, db.tokens,
                                                                   db.lengths))
                            for p in query]
            except Exception:  # a query that fails is counted, and the run goes on
                failed += 1
                log("query failed:\n" + traceback.format_exc())
                continue
            latencies.append(time.perf_counter() - t)
            msv_cells += sum(work.cells(db.residues, leng[p]) for p in query)
            pool.offer(done)
            if traced:
                _count_work(stage_work, rows_given, done, db, leng)
        t1 = time.perf_counter()
    log(f"window {t1 - t0:.3f} s: {len(latencies)} queries, {failed} failed")
    attempted = len(latencies) + failed
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if traced:
        summary = trace_mod.summarize(_read_trace(trace_dir))
    phase = {k: pipe.phase_totals[k] - before[k] for k in before}
    window = Window(t1 - t0, latencies, msv_cells, phase, setup_s, stage_work, rows_given,
                    summary)

    checked = pool.sample()
    strata = [np.asarray(rows, dtype=np.int64) for rows in bucketed.order]
    del pipe, scanner, bucketed, hmms
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    library = [hmm_mod.parse(p) for p in paths]
    thresholds = {"msv": config["guarantees"]["msv_p"], "viterbi": config["guarantees"]["viterbi_p"],
                  "forward": config["guarantees"]["forward_p"]}
    t_check = time.perf_counter()
    numbers = check.compare(library, checked, db.family, db.tokens, db.lengths, strata,
                            thresholds, traffic, np.random.default_rng([generator.seed_bits(seed), 3]),
                            device, log, control) if checked else {n: check.BROKEN for n in check.NUMBERS}
    log(f"check {time.perf_counter() - t_check:.3f} s over {len(checked)} searched profiles")
    limits = check.load_limits(cell.name)
    correct = (failed == 0 and attempted > 0 and bool(checked)
               and all(numbers[n] <= limits[n] for n in check.NUMBERS))

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
        "power_limit": card,
    }
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in summary.device_ops],
                            "idle_gaps": summary.idle_gaps}
    out["check"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NUMBERS}
    out["numbers"], out["limits"] = numbers, limits
    return out


def _count_work(stage_work: dict, rows_given: dict, done: list, db, leng: list) -> None:
    """Add the rows, operations and bytes each stage was given: MSV every
    row, Viterbi the MSV survivors, Forward the Viterbi survivors."""
    rows_all = len(db.lengths)
    for c in done:
        for stage, rows, residues in (
            ("msv", rows_all, db.residues),
            ("viterbi", int(c.result.passed_msv.sum()),
             int(db.lengths[c.result.passed_msv].astype(np.int64).sum())),
            ("forward", int(c.result.passed_viterbi.sum()),
             int(db.lengths[c.result.passed_viterbi].astype(np.int64).sum())),
        ):
            rows_given[stage] += rows
            if rows:
                ops, nbytes = work.stage_work(stage, rows, residues, leng[c.profile])
                stage_work[stage][0] += ops
                stage_work[stage][1] += nbytes


def _read_trace(trace_dir: str) -> dict:
    try:
        files = sorted(pathlib.Path(trace_dir).glob("*.json"))
        if not files:
            raise RuntimeError("the traced run wrote no trace")
        return json.loads(files[-1].read_text())
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
