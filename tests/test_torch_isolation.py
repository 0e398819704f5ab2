"""The PyTorch port stands alone: it loads no JAX and nothing of the JAX
package, it never falls back from the kernel to its plain version, and it
builds for Hopper without fast math."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch import MSVScanner
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda, p7_cuda, posterior_cuda

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = REPO_ROOT / "hmm_fasta_viterbi_tpu_torch"
JAX_PACKAGE = "hmm_fasta_viterbi_tpu"

_NO_JAX = """
import sys
import torch
torch.set_num_threads(1)  # the suite's workers share the cores
import chip_smoke
import hmm_fasta_viterbi_tpu_torch
import hmm_fasta_viterbi_tpu_torch.__main__
import hmm_fasta_viterbi_tpu_torch.convert
import hmm_fasta_viterbi_tpu_torch.ops._build
import hmm_fasta_viterbi_tpu_torch.ops.p7_cuda
import hmm_fasta_viterbi_tpu_torch.bench
import hmm_fasta_viterbi_tpu_torch.bench.__main__
import hmm_fasta_viterbi_tpu_torch.bench.harness
import hmm_fasta_viterbi_tpu_torch.bench.rows
from hmm_fasta_viterbi_tpu_torch import cli
assert cli.main(["scan", "--device", "cpu", "--hmm", sys.argv[1],
                 "--fasta", sys.argv[2], "--out", sys.argv[3]]) == 0
assert cli.main(["scan", "--device", "cpu", "--stage", "search", "--hmm", sys.argv[1],
                 "--fasta", sys.argv[2], "--out", sys.argv[3] + ".search"]) == 0
assert cli.main(["scan", "--device", "cpu", "--stage", "search", "--fast", "--hmm",
                 sys.argv[1], "--fasta", sys.argv[2], "--out", sys.argv[3] + ".fast"]) == 0
assert cli.main(["scan", "--device", "cpu", "--stage", "search", "--fused", "--hmm",
                 sys.argv[1], "--fasta", sys.argv[2], "--out", sys.argv[3] + ".fused"]) == 0
assert cli.main(["scan", "--device", "cpu", "--stage", "search", "--domains", "--hmm",
                 sys.argv[1], "--fasta", sys.argv[4], "--out", sys.argv[3] + ".domains"]) == 0
for stage in ("msv", "search"):
    assert cli.main(["sweep", "--device", "cpu", "--stage", stage, "--fast", "--hmm-db",
                     sys.argv[1], "--fasta", sys.argv[2],
                     "--out", sys.argv[3] + ".sweep_" + stage]) == 0
assert cli.main(["scan", "--device", "cpu", "--stream", "2", "--hmm", sys.argv[1],
                 "--fasta", sys.argv[2], "--out", sys.argv[3] + ".stream"]) == 0
for flags in (["--bucketed"], ["--checkpoint", sys.argv[3] + ".ckpt"]):
    assert cli.main(["sweep", "--device", "cpu", "--hmm-db", sys.argv[1], "--fasta",
                     sys.argv[2], *flags, "--out", sys.argv[3] + ".sweep" + flags[0]]) == 0
cfg = sys.argv[3] + ".cfg.json"
open(cfg, "w").write('{"msv_p": 0.05}')
assert cli.main(["scan", "--device", "cpu", "--stage", "search", "--align", "--msa-out",
                 sys.argv[3] + ".sto", "--config", cfg, "--profile-trace", sys.argv[3] + ".trace",
                 "--hmm", sys.argv[1], "--fasta", sys.argv[4],
                 "--out", sys.argv[3] + ".align"]) == 0
assert cli.main(["emit", "--hmm", sys.argv[1], "--count", "4", "--seed", "1",
                 "--out", sys.argv[3] + ".emit"]) == 0
assert cli.main(["align", "--hmm", sys.argv[1], "--fasta", sys.argv[3] + ".emit", "--format",
                 "stockholm", "--out", sys.argv[3] + ".emit.sto"]) == 0
assert cli.main(["build", "--device", "cpu", "--msa", sys.argv[3] + ".emit.sto",
                 "--out", sys.argv[3] + ".built.hmm"]) == 0
assert cli.main(["info", "--hmm", sys.argv[3] + ".built.hmm", "--consensus",
                 "--out", sys.argv[3] + ".info"]) == 0
assert cli.main(["generate", "--seed", "1", "--count", "2", "--length", "30",
                 "--out", sys.argv[3] + ".gen"]) == 0
assert cli.main(["scan", "--device", "cpu", "--mesh", "db=2,sp=2", "--stage", "search",
                 "--hmm", sys.argv[1], "--fasta", sys.argv[4],
                 "--out", sys.argv[3] + ".sp_search"]) == 0
assert cli.main(["scan", "--device", "cpu", "--mesh", "db=2", "--stage", "search",
                 "--hmm", sys.argv[1], "--fasta", sys.argv[4],
                 "--out", sys.argv[3] + ".db_search"]) == 0
import hmm_fasta_viterbi_tpu_torch.parallel.dryrun
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "hmm_fasta_viterbi_tpu" or m.startswith("hmm_fasta_viterbi_tpu."))
assert not loaded, loaded
"""


def test_port_and_chip_smoke_import_no_jax(profile_dir, fasta_dir, tmp_path):
    """In a fresh interpreter: import the port, its CLI, its bench and
    chip_smoke.py, run a CPU scan, a CPU search with and without --fast, a CPU search with
    --domains on a consensus hit, CPU sweeps, a streamed scan, a bucketed
    and a checkpointed sweep, a search with --align, --msa-out, --config
    and --profile-trace, emit, align, build, info and generate, and a
    search on a db x sp mesh (the wavefront) and on a db mesh, and find no
    jax module and no module of the JAX package loaded."""
    from hmm_fasta_viterbi_tpu_torch import parse_hmm
    from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS

    hmm = parse_hmm(profile_dir / "100.hmm")
    consensus = "".join(AMINO_ACIDS[a] for a in np.argmax(hmm.match_emissions[1:], axis=1))
    hit = tmp_path / "hit.fsa"
    hit.write_text(f">consensus\n{consensus}\n>junk\nACDEFGHIKLMNPQRSTVWY\n")
    proc = subprocess.run(
        [
            sys.executable, "-c", _NO_JAX, str(profile_dir / "100.hmm"),
            str(fasta_dir / "fasta_like_example.fsa"), str(tmp_path / "out.tsv"), str(hit),
        ],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    domains = (tmp_path / "out.tsv.domains").read_text().splitlines()
    assert domains[0].endswith("\tenv_from\tenv_to\tndom\tdom_scores")
    assert domains[1].startswith("consensus") and domains[1].split("\t")[-2] == "1"
    assert (tmp_path / "out.tsv").read_text().startswith("# target")
    assert (tmp_path / "out.tsv.search").read_text().startswith("# target\tprofile\tmsv_bits")
    assert (tmp_path / "out.tsv.fast").read_text().startswith("# target\tprofile\tmsv_bits")
    assert (tmp_path / "out.tsv.sweep_msv").read_text().startswith("# target\tprofile\tscore")
    assert (tmp_path / "out.tsv.sweep_search").read_text().startswith("# target\tprofile\tmsv")
    whole = (tmp_path / "out.tsv").read_bytes()
    assert (tmp_path / "out.tsv.stream").read_bytes() == whole
    assert (tmp_path / "out.tsv.sweep--bucketed").read_bytes() == whole
    assert (tmp_path / "out.tsv.sweep--checkpoint").read_bytes() == whole
    assert list((tmp_path / "out.tsv.ckpt").glob("*.shard00000.npz"))
    assert "\n== consensus domain 1 [hmm 1-100 / seq 1-100]" in (
        tmp_path / "out.tsv.align").read_text()
    assert (tmp_path / "out.tsv.sto").read_text().startswith("# STOCKHOLM 1.0")
    assert len(list((tmp_path / "out.tsv.trace").glob("*.pt.trace.json"))) == 1
    assert (tmp_path / "out.tsv.built.hmm").read_text().startswith("HMMER3/b")
    assert (tmp_path / "out.tsv.info").read_text().count("\n") == 2
    assert (tmp_path / "out.tsv.gen").read_text().count(">") == 2
    search = (tmp_path / "out.tsv.sp_search").read_bytes()
    assert search.startswith(b"# target\tprofile\tmsv_bits") and b"consensus" in search
    assert (tmp_path / "out.tsv.db_search").read_bytes() == search


def _jax_package_imports(path: pathlib.Path) -> list[str]:
    """The imports of the JAX package (or of jax) in one Python file."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in (JAX_PACKAGE, "jax")]
    return found


def test_no_file_of_the_port_imports_the_jax_package():
    """An AST scan of every .py file of the port (its parallel/ and bench/
    packages among them), of chip_smoke.py and of the port's tools (the timing
    tools, the multi-process smoke) finds no import of hmm_fasta_viterbi_tpu
    (or jax), at any depth."""
    files = sorted(PORT_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py",
                                              REPO_ROOT / "tools" / "torch_p7_timing.py",
                                              REPO_ROOT / "tools" / "torch_msv_timing.py",
                                              REPO_ROOT / "tools" / "torch_multihost_smoke.py"]
    assert len(files) > 20
    assert {f.name for f in files} >= {"hmmio.py", "loader.py", "reference.py", "stats.py",
                                       "posterior_cuda.py", "chip_smoke.py",
                                       "torch_p7_timing.py", "torch_msv_timing.py",
                                       "traceback.py", "msaio.py", "hmmwrite.py", "build.py",
                                       "generate.py", "config.py"}
    parallel = sorted((PORT_DIR / "parallel").glob("*.py"))
    assert {f.name for f in parallel} == {"__init__.py", "mesh.py", "database.py",
                                          "seqblocks.py", "dryrun.py"}
    assert set(parallel) <= set(files)
    bench = sorted((PORT_DIR / "bench").glob("*.py"))
    assert {f.name for f in bench} == {"__init__.py", "__main__.py", "harness.py", "rows.py"}
    assert set(bench) <= set(files)
    runtime = sorted((PORT_DIR / "runtime").glob("*.py"))
    assert {f.name for f in runtime} == {"__init__.py", "checkpoint.py", "config.py",
                                         "profiling.py"}
    assert set(runtime) <= set(files)
    bad = {str(f.relative_to(REPO_ROOT)): _jax_package_imports(f) for f in files}
    assert not {k: v for k, v in bad.items() if v}
    # the scan finds such imports where they are
    assert _jax_package_imports(REPO_ROOT / "tests" / "test_torch_p7.py")


def test_cuda_scanner_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        MSVScanner(device="cuda")


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """msv_scan sends every tensor that is not on the CPU to the kernel
    wrapper, which raises for a device it cannot launch on: no fallback."""

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(msv_cuda, "msv_scan_plain", plain)
    b, l, m = 4, 8, 16
    args = [
        torch.empty((20, m), device="meta"),
        torch.empty((b, l), dtype=torch.int8, device="meta"),
        torch.empty((b,), dtype=torch.int32, device="meta"),
        torch.empty((2, b), device="meta"),
        torch.empty((3,), device="meta"),
        torch.empty((b, m), device="meta"),
        torch.empty((4, b), device="meta"),
    ]
    before = msv_cuda.msv_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_scan(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_scan_cuda(*[torch.zeros(a.shape, dtype=a.dtype) for a in args])
    assert msv_cuda.msv_scan_cuda.launches == before


def test_nvcc_command_targets_hopper_without_fast_math():
    """One nvcc a source (they run side by side), then one link into the
    shared library."""
    compiles, link = _build.nvcc_commands("nvcc", pathlib.Path("out"), pathlib.Path("lib.so"))
    srcs = {cmd[-1] for cmd in compiles}
    for name in ("msv_kernel.cu", "p7_viterbi_kernel.cu", "p7_forward_kernel.cu",
                 "p7_viterbi_filter_kernel.cu", "p7_forward_log_kernel.cu",
                 "p7_backward_kernel.cu"):
        assert str(_build.CSRC_DIR / name) in srcs
    assert len(srcs) == 6
    # the striped Viterbi filter and backward pass are gone: both are cases
    # of the blocked layout
    assert not (_build.CSRC_DIR / "p7_filter_kernel.cu").exists()
    assert not (_build.CSRC_DIR / "posterior_kernel.cu").exists()
    # the shared Viterbi / log-space Forward / filter template is a header
    # three sources include; it and the Forward kernel include the blocked
    # layout's header
    assert [h.name for h in _build.headers()] == ["p7_blocked.cuh", "p7_viterbi.cuh"]
    for name in ("p7_viterbi_kernel.cu", "p7_forward_log_kernel.cu",
                 "p7_viterbi_filter_kernel.cu"):
        assert '#include "p7_viterbi.cuh"' in (_build.CSRC_DIR / name).read_text()
    for name in ("p7_viterbi.cuh", "p7_forward_kernel.cu", "p7_backward_kernel.cu"):
        assert '#include "p7_blocked.cuh"' in (_build.CSRC_DIR / name).read_text()
    for cmd in compiles:
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined and "-c" in cmd and "-O3" in cmd
        assert "fast_math" not in joined and "fast-math" not in joined
    assert "-shared" in link and len(link) == 4 + len(compiles)


def test_kernel_supports_every_profile(all_profile_paths):
    """Every profile of data/profile_HMMs fits the kernel's register row
    (LENG 100-2405); the lane counts match the C++ switch."""
    from hmm_fasta_viterbi_tpu_torch import parse_hmm

    source = (_build.CSRC_DIR / "msv_kernel.cu").read_text()
    for per in msv_cuda.KERNEL_PER:
        assert per % 8 == 4 and f"MSV_CASE({per}, 32)" in source
    for per in msv_cuda.WIDE_PER:  # two warps a sequence past 2432 states
        assert per % 8 == 4 and f"MSV_CASE({per}, 64)" in source
    lengs = [parse_hmm(p).model_length - 1 for p in all_profile_paths]
    assert len(lengs) == 24 and max(lengs) == 2405
    assert all(msv_cuda.kernel_case(n) == (32, msv_cuda.kernel_per(n)) for n in lengs)
    assert all(32 * msv_cuda.kernel_per(n) >= n for n in lengs)
    assert np.all(np.diff(msv_cuda.KERNEL_PER) == 8)


def _meta_p7_args(n_specials, consts, chain_rows=16):
    b, l, m = 4, 8, 16
    return [
        torch.empty((20, m), device="meta"),
        torch.empty((20, m), device="meta"),
        torch.empty((8, m), device="meta"),
        torch.empty((chain_rows, m), device="meta"),
        torch.empty((b, l), dtype=torch.int8, device="meta"),
        torch.empty((b,), dtype=torch.int32, device="meta"),
        torch.empty((2, b), device="meta"),
        torch.empty((consts,), device="meta"),
        torch.empty((b, m), device="meta"),
        torch.empty((b, m), device="meta"),
        torch.empty((b, m), device="meta"),
        torch.empty((n_specials, b), device="meta"),
    ]


def test_p7_scans_never_fall_back(monkeypatch):
    """viterbi_scan, viterbi_lazy_scan and forward_prob_scan send every
    tensor that is not on the CPU to their kernel wrappers, which raise for
    a device they cannot launch on; no launch is counted."""

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    for name in ("viterbi_scan_plain", "viterbi_lazy_scan_plain", "forward_prob_scan_plain"):
        monkeypatch.setattr(p7_cuda, name, plain)
    wrappers = (p7_cuda.viterbi_scan_cuda, p7_cuda.viterbi_lazy_scan_cuda,
                p7_cuda.forward_prob_scan_cuda)
    before = [w.launches for w in wrappers]
    vit = _meta_p7_args(4, 3)
    lazy = _meta_p7_args(4, 5)
    fwd = _meta_p7_args(8, 3, chain_rows=3)
    fwd.insert(7, torch.empty((2, 4), device="meta"))  # tr_probs
    for scan, args in ((p7_cuda.viterbi_scan, vit), (p7_cuda.viterbi_lazy_scan, lazy + [2]),
                       (p7_cuda.forward_prob_scan, fwd)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            scan(*args)
    cpu = [torch.zeros(a.shape, dtype=a.dtype) for a in vit]
    with pytest.raises(ValueError, match="CUDA tensors"):
        p7_cuda.viterbi_scan_cuda(*cpu)
    assert [w.launches for w in wrappers] == before


def test_p7_kernels_support_every_profile(all_profile_paths):
    """Every profile's p7 pack (JAX M_pad convention) fits the p7 kernels'
    threads, and the thread counts match the C++ switches."""
    from hmm_fasta_viterbi_tpu_torch import P7Profile, parse_hmm

    cases = [(p7_cuda.KERNEL_THREADS, per) for per in p7_cuda.KERNEL_PER]
    cases += [(p7_cuda.WIDE_THREADS, per) for per in p7_cuda.WIDE_PER]
    source = (_build.CSRC_DIR / "p7_blocked.cuh").read_text()
    assert all(f"P7_CASE({per}, {threads})" in source for threads, per in cases)
    assert f"kMemThreads = {p7_cuda.MEM_THREADS};" in source
    assert f"kMemRows = {p7_cuda.MEM_ROWS};" in source
    for name in ("p7_viterbi_kernel.cu", "p7_forward_kernel.cu", "p7_viterbi_filter_kernel.cu",
                 "p7_forward_log_kernel.cu", "p7_backward_kernel.cu"):
        source = (_build.CSRC_DIR / name).read_text()
        assert "with_case<Case>(threads, per" in source
        assert "if (threads == kMemThreads)" in source
    for path in all_profile_paths:
        p7 = P7Profile.from_profile(parse_hmm(path))
        m_pad = p7_cuda.default_m_pad(p7)
        assert p7_cuda.KERNEL_THREADS * p7_cuda.kernel_per(m_pad) >= m_pad
        assert p7_cuda.e_skip_d_ok(p7)  # the lazy kernel carries every real profile


def test_filter_and_stacked_scans_never_fall_back(monkeypatch):
    """msv_filter_scan, msv_stacked_scan and viterbi_filter_scan send every
    tensor that is not on the CPU to their kernel wrappers, which raise for
    a device they cannot launch on; no launch is counted."""

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    for mod, name in ((msv_cuda, "msv_filter_scan_plain"), (msv_cuda, "msv_stacked_scan_plain"),
                      (p7_cuda, "viterbi_filter_scan_plain")):
        monkeypatch.setattr(mod, name, plain)
    wrappers = (msv_cuda.msv_filter_scan_cuda, msv_cuda.msv_stacked_scan_cuda,
                p7_cuda.viterbi_filter_scan_cuda)
    before = [w.launches for w in wrappers]
    b, l, m = 4, 8, 16
    tok = torch.empty((b, l), dtype=torch.int8, device="meta")
    lens = torch.empty((b,), dtype=torch.int32, device="meta")
    rows = torch.empty((2, b), device="meta")
    carry = (torch.empty((b, m), device="meta"), torch.empty((4, b), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_filter_scan(torch.empty((20, m), dtype=torch.bfloat16, device="meta"),
                                 tok, lens, rows, torch.empty((3,), device="meta"), *carry)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_stacked_scan(torch.empty((2, 20, m), device="meta"), tok, lens, rows,
                                  torch.empty((2, 3), device="meta"))
    vit = _meta_p7_args(4, 4)
    vit[0] = torch.empty((20, m), dtype=torch.bfloat16, device="meta")
    vit[1] = torch.empty((20, m), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        p7_cuda.viterbi_filter_scan(*vit, 2, True)
    cpu = [torch.zeros(a.shape, dtype=a.dtype) for a in vit]
    with pytest.raises(ValueError, match="CUDA tensors"):
        p7_cuda.viterbi_filter_scan_cuda(*cpu, 2, True)
    assert [w.launches for w in wrappers] == before


def test_msv_table_types_and_stack_in_one_source():
    """The MSV source carries the f32 and the bf16 table and the profile grid
    axis; the filter's bf16 table widens by a shift (no float conversion
    that could round)."""
    source = (_build.CSRC_DIR / "msv_kernel.cu").read_text()
    assert "struct Entries<uint16_t>" in source and "struct Entries<float>" in source
    assert "blockIdx.y" in source and "raw.x << 16" in source


def test_log_forward_and_posterior_scans_never_fall_back(monkeypatch):
    """forward_log_scan, forward_save_scan and backward_coverage_scan send
    every tensor that is not on the CPU to their kernel wrappers, which
    raise for a device they cannot launch on; no launch is counted."""

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(p7_cuda, "forward_log_scan_plain", plain)
    for name in ("forward_save_scan_plain", "backward_coverage_scan_plain"):
        monkeypatch.setattr(posterior_cuda, name, plain)
    wrappers = (p7_cuda.forward_log_scan_cuda, posterior_cuda.forward_save_scan_cuda,
                posterior_cuda.backward_coverage_scan_cuda)
    before = [w.launches for w in wrappers]
    b, l, m = 4, 8, 16
    log = _meta_p7_args(4, 3)
    fwd = _meta_p7_args(8, 3, chain_rows=3)
    fwd.insert(7, torch.empty((2, b), device="meta"))  # tr_probs
    bwd = [
        torch.empty((20, m), device="meta"), torch.empty((20, m), device="meta"),
        torch.empty((8, m), device="meta"), torch.empty((3, m), device="meta"),
        torch.empty((b, l), dtype=torch.int8, device="meta"),
        torch.empty((b,), dtype=torch.int32, device="meta"),
        torch.empty((2, b), device="meta"), torch.empty((3,), device="meta"),
        torch.empty((b,), device="meta"),
        torch.empty((b, l, m), dtype=torch.bfloat16, device="meta"),
        torch.empty((b, l), device="meta"),
    ]
    for scan, args in ((p7_cuda.forward_log_scan, log), (posterior_cuda.forward_save_scan, fwd),
                       (posterior_cuda.backward_coverage_scan, bwd)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            scan(*args)
    for wrapper, args in zip(wrappers, (log, fwd, bwd)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(*[torch.zeros(a.shape, dtype=a.dtype) for a in args])
    assert [w.launches for w in wrappers] == before


def test_log_forward_kernel_uses_accurate_math_only():
    """The log-space Forward's combine and E reduce call the accurate expf,
    log1pf and logf, never the fast intrinsics."""
    source = (_build.CSRC_DIR / "p7_viterbi.cuh").read_text()
    assert "log1pf(expf(d))" in source and "logf(group_reduce<true, KT>" in source
    source += (_build.CSRC_DIR / "p7_blocked.cuh").read_text()
    for fast in ("__expf", "__logf", "__log1pf", "__fdividef"):
        assert f"{fast}(" not in source
