"""On-card smoke test of the PyTorch port (hmm_fasta_viterbi_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (device 0) and the CUDA toolkit's nvcc. In order:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: loads the native loader (built with g++ into _kernels/ at first
   use; the CLI parses with Python without it) and prints its library or
   why it failed; compiles csrc/*.cu from this checkout, one nvcc a source, and
   prints each kernel case's registers and spills (the rows-in-memory
   kernels, `*_mem_kernel`, included; the MSV register cases once for each
   block size W they are compiled for; the cluster kernels,
   `msv_kernel<PER,true,...>` (every C), `viterbi_pair_kernel`,
   `forward_pair_kernel`, `viterbi_cluster_kernel` and
   `forward_cluster_kernel` (every C), and the eager and log-space wide
   block, `viterbi_block_kernel`), the launch plan of each MSV case at the timed
   shapes (W, grid, dynamic shared memory, with the registers and spill
   bytes of that kernel; the wide profiles' cluster pairs and the joins'
   C-block clusters, C = 3, 13, 5, 8, 9, with their clusters and
   cudaOccupancyMaxActiveClusters) and the
   launch plan of each blocked p7 case (the Viterbi filter's and the
   backward pass's included) against 1400.hmm, the wider wide profile and
   both joins past 4864 states (MEM_JOINS) at the timed shapes (threads a
   group, groups G, grid, staged chain and transition rows, dynamic shared
   memory; for a cluster pair or a C-block cluster its clusters and
   cudaOccupancyMaxActiveClusters);
3. log-space Forward and posterior kernels against plain, all 24 profiles:
   the log-space Forward kernel within LOG_FWD_TOL of its plain version on
   a ragged batch of 64 sequences up to 600 residues, and a two-call carry
   chain equal to one call; the row-saving Forward kernel's scores and
   carries equal to the Forward kernel's bit for bit; both kernels at the
   most groups a block that fit (G > 1) equal to themselves at G = 1; the
   posterior kernels' coverage and totals within COV_TOL / TOT_TOL of the
   plain decode on the card, coverage 0 past each length; the backward
   kernel (a case of the blocked layout) on the row-saving kernel's own rows
   within COV_TOL of its plain version, at G = 1 and, bit for bit, at the
   most groups a block that fit;
4. MSV kernels against plain: for all 24 profiles of data/profile_HMMs, on
   one ragged batch, the MSV kernel and the MSV filter kernel (bf16 table)
   each equal their plain PyTorch version, and a two-call carry chain one
   call (max |d| = 0.0); the filter is >= the exact kernel on every
   sequence; one scan_many over all 24 profiles in each mode (the stacked
   kernel) equals the single-profile kernels bit for bit; on 1400.hmm and
   2405.hmm every block size W the kernel is compiled for equals the
   default plan in both modes, and a stack of STRIDE_COPIES copies of the
   profile (a few blocks a profile: each warp walks many sequences) equals
   the single scan row for row; the bucketed MSV stage at the proteome
   configuration's lengths (hmmbench/configs/pfam_scan_proteome.json, titin
   34,350 the longest): scan_bucketed of 100.hmm, 1400.hmm and 2405.hmm in
   both modes is one launch of the row table kernel and nothing else, its
   scores equal to the plain row table scan bit for bit;
5. MSV kernel against the NumPy oracle on 8 sequences of 1400.hmm and
   2405.hmm;
6. Viterbi and Forward kernels against plain, all 24 profiles, on a ragged
   batch of 64 sequences up to 600 residues (lengths 0, 1, 31, 32, 33, 257
   among them): eager Viterbi == plain, lazy == eager (scores and carries,
   bit for bit), lazy at lazy_k = 1 on 100.hmm replays chunks and equals
   the plain lazy version, replay counts included; Forward within FWD_TOL
   of plain; the eager, lazy, Forward and Viterbi filter kernels at G = 1
   (the launch plan's pick for 64 rows) equal to themselves at the most
   groups a block that fit (G > 1 on most profiles), bit for bit; the
   Viterbi filter kernel == plain (carries included) and >= eager Viterbi
   on every sequence; two-call carry chains equal one call
   (Forward split at a multiple of FWD_RESCALE_GROUP); the Viterbi filter
   at every window 1..full_passes on 100.hmm and 1400.hmm, and on 100.hmm
   made to fail e_skip_d (a positive tdd: the full chain; a positive tmd: a
   truncated window whose tail reaches E);
7. Viterbi, Viterbi filter, Forward and log-space Forward kernels against
   the oracles on short sequences of 100.hmm and 1400.hmm (1e-4, filter >=
   oracle, 2e-3, 2e-3), and the posterior kernels against
   reference.posterior_match there (COV_TOL, TOT_TOL);
8. the profiles wider than 2432 states (WIDE_PAIRS: the nodes of 1400.hmm
   and 1301.hmm, LENG 2701, and of 2405.hmm and 2365.hmm, LENG 4770, joined
   into one ProfileHMM each): every kernel's wide case against its plain
   version on a ragged batch of 8 sequences up to 300 residues, at G = 1
   and at the most groups that fit (every kind's cluster pair takes G =
   1), the backward pass's pair on the row-saving kernel's own rows within
   COV_TOL, a Forward
   carry chain split at P7_SPLIT equal to one call bit for bit, and the
   stacked kernel over 100.hmm and both (wide_kernels_vs_plain); then the
   MSV kernels' C-block clusters (cluster_kernels_vs_plain): MEM_JOINS (the
   nodes of 2405.hmm, 2365.hmm and 2207.hmm, LENG 6977, C = 3, and of all
   24, LENG 30181, C = 13) and CLUSTER_JOINS (LENG 11165, 18170, 19679: C =
   5, 8, 9) through MSV (with a carry chain), the MSV filter and a stacked
   launch each, bit for bit with the plain versions, the launch counters
   showing each at its C, and the stacked kernel over 100.hmm and all five
   (one launch a C) == the single scans; the all-24 join twice over (LENG
   60362, past 38,912) through the MSV kernels' 16-block cluster of 8-warp
   blocks the same way (the counters showing C = 16 alone); then MEM_JOINS
   (15 chain passes at LENG 30181) through every
   p7 kernel past 4864 states against its plain version on the same kind
   of batch (mem_kernels_vs_plain: the lazy Viterbi, the Viterbi filter,
   Forward, the row-saving Forward and the backward pass on their 3- and
   13-block clusters, the eager Viterbi and the log-space Forward on the
   wide block at LENG 6977 and on 4 wide blocks at 30181; eager (scores and
   carries, and a carry chain), lazy and the Viterbi filter bit for bit,
   the lazy kernel also at lazy_k = 1 with its fire count printed and above
   0, Forward, log-space Forward and the posterior pair within their
   tolerances, the launch counters showing each kind at its case alone),
   and the LENG 60362 join through the eager, log-space and lazy kinds'
   cluster of 8 wide blocks (the lazy kernel == plain bit for bit with 0
   replays, its scores == eager's, a carry chain == one call) and Forward's,
   the row-saving Forward's, the backward pass's and the Viterbi filter's
   cluster of 13 256-thread blocks the same way (Forward within FWD_TOL of
   plain, the row-saving Forward == Forward bit for bit, the filter == plain
   bit for bit at its window of 7 and >= the lazy scores), and the lazy
   kind, Forward, the posterior pair, the Viterbi filter and MSV (exact,
   filter, stacked) again on their rows-in-memory route, once each
   (mem_route_past_38912: no_block_clusters, the occupancy query answering
   0; the lazy kernel, the filter and MSV == plain, Forward within FWD_TOL,
   the row-saving kernel == the Forward kernel bit for bit); then the
   eager Viterbi and the log-space Forward on their clusters of 2 and 3 wide
   blocks (CLUSTER_JOINS) against plain, each timed once at 64 x 1000, and
   their rows-in-memory route at LENG 30181 on a card that holds no such
   cluster against plain (block_cluster_kernels_vs_plain); then the short
   release stress of the C-block clusters (release_stress:
   tools/torch_cluster_check.py --stress in a process of its own, 10
   launches a kind at C = 4, 8, 13, 16 of 128-thread blocks, of Forward,
   the posterior pair and the Viterbi filter at C = 13 of 256-thread
   blocks, of the lazy Viterbi on 8 wide blocks and of MSV, the MSV filter
   and the stacked kernel on the 16-block cluster of 8-warp blocks at M_pad
   60368, none hung, each equal to its case's first);
9. main paths, each with every launch count set to 0 just before it and
   read just after, on a seeded FASTA of 16384 x 3500 random residues with
   32 sequences sampled from 1400.hmm and 4 from the LENG 4770 profile at
   known rows:
   `scan --stage msv` (the MSV kernel; the top 8 rows equal the oracle),
   `scan --stage search` (MSV, then the lazy Viterbi and the Forward
   kernels; every planted row is a hit), `scan --stage viterbi` and
   `--stage forward` (every row scored, the planted rows on top), the
   single-stage Viterbi entry with lazy=False at 4096 x 3500 (the eager
   kernel), `scan --stage search --fast` (the MSV filter, MSV, Viterbi
   filter, lazy Viterbi and Forward kernels; the non-fast search's hit set
   and hit rows), `sweep --hmm-dir data/profile_HMMs` (the stacked kernel;
   its 1400.hmm rows equal the scan's), `sweep --stage search --fast`
   over the 24 profiles (both filter kernels), `scan --stage search
   --domains` (the posterior kernels and the Forward kernel's domain
   rescoring; every planted row a hit with its envelope inside it, the
   envelopes those of the kernels' coverage and of the plain decode's on
   the card), the log-space Forward entry as validate_hw.py's long-L
   referee (one sequence of 36864 residues of 100.hmm, the probability-space
   Forward within 5e-3 of it), and the wide cases (wide_paths): `sweep
   --stage search --fast` over the 24 profiles and the two wide ones, `sweep`
   over 100.hmm and the wide ones, and the eager, log-space and posterior
   entry points on the planted wide rows; and the cases past 4864 states
   (mem_paths): `scan --stage search --domains` with the LENG 6977 join
   against a FASTA of 2048 rows with 4 of its homologs planted (MSV, the
   lazy Viterbi, Forward, the row-saving Forward and the backward pass on
   their 3-block clusters and none of them in memory; every planted row a hit with its
   envelope inside it), `--fast` on it (the MSV filter's and the Viterbi
   filter's 3-block clusters, none in memory), `sweep` over both joins and
   the LENG 60362 one (the stacked kernel's 3- and 13-block clusters and
   its 16-block cluster of 8-warp blocks), `scan` and
   MSVScanner.scan_filter with the LENG 60362 join (the MSV kernels'
   16-block cluster of 8-warp blocks), the eager and log-space entry points
   on the planted rows (the wide block, none in memory), and the eager
   Viterbi, lazy Viterbi, Viterbi filter, Forward, log-space Forward and
   posterior entry points with the LENG 60362 join (the eager, log-space
   and lazy kinds' cluster of 8 wide blocks, Forward's, the posterior
   pair's and the filter's cluster of 13 256-thread blocks), the lazy,
   Forward, posterior and filter entries and MSVScanner.scan, scan_filter
   and scan_many there again through the rows-in-memory route of a card
   that holds none of those clusters (== the clusters' scores, coverage
   within COV_TOL), and the eager and
   log-space entry points with the LENG 30181 join through the
   rows-in-memory route of a card that holds no cluster of wide blocks, ==
   their cluster of 4;
   survivor counts and per-phase seconds printed;
10. timings with CUDA events: the MSV kernel (best of 3) at 16384 x 3500
   against 1400.hmm and 2405.hmm and its plain version at 1400.hmm; the MSV
   filter at 16384 x 3500 x 1400 (filter_1400) and its plain version once;
   the lazy and eager Viterbi, the Viterbi filter (auto window), the
   Forward and the log-space Forward kernels (best of 3) at 4096 x 3500
   against 1400.hmm (forward_log_1400 the last), the lazy fire rate, and
   each plain version once at that shape, held against the kernel; the
   same five kernels at the survivor shape 64 x 3500 (<kernel>_1400_b64,
   best of 3), each line with its launch plan; the stacked sweep over all
   24 profiles at 8192 x 3500 in both modes, one line a stacked launch
   (a kernel case) and the whole (sweep24, sweep24_filter; best of 3), the
   plain exact sweep once over all 24 and the plain filter sweep once over
   every fourth profile, scaled by cells; the posterior kernels at 1024 x
   1024 against 1400.hmm (posterior_1400, posterior_mask_1400; best of 3)
   and their plain versions once; each wide case once against the LENG 4770
   profile (wide_timings: MSV at 2048 x 3500, the p7 kernels at 64 x 3500,
   the posterior kernels at 64 x 1024; each line with its bound, its share
   and PARENT_WIDE_MS's time of the parent commit beside it, with the
   card's name and power limit), and each case past 4864 states
   (mem_timings: the MSV clusters against the LENG 6977 join at 2048 x 1000
   and the stacked kernel over it and the LENG 30181 join, best of 3; the
   MSV kernels' 16-block cluster of 8-warp blocks against the LENG 60362
   join at 256 x 1000 (`<kernel>_cluster256`, best of 3) and their
   rows-in-memory route there (`<kernel>_mem`, once); the
   p7 kernels at 64 x 1000 and the posterior pair at 64 x 1024 against the
   LENG 6977 join (the lazy Viterbi, the Viterbi filter, Forward, the
   row-saving Forward and the backward pass on 3-block clusters, the eager
   Viterbi and the log-space Forward on the wide block, best of 3, both
   also at build's calibration shape, 256 x 400, `<kernel>_block_cal`), the
   five on 13-block clusters against the LENG 30181 join
   (`<kernel>_cluster_30181`, best of 3) with the eager and log-space
   Forward on 4 wide blocks there (`<kernel>_blocks_30181`, best of 3;
   also at 256 x 400, `<kernel>_blocks_cal`) and through the rows-in-memory
   route of a card without such clusters (`<kernel>_mem`, once), and
   against the LENG 60362 join the eager Viterbi, the log-space Forward
   and the lazy Viterbi on 8 wide blocks (`<kernel>_blocks`, best of 3),
   Forward, the posterior pair and the Viterbi filter on 13 256-thread
   blocks (`<kernel>_cluster256`, best of 3), the lazy Viterbi, Forward,
   the posterior pair and the filter on their rows-in-memory route
   (`<kernel>_mem`, once), and the posterior pair at one
   posterior_coverage_batch chunk there (26 x 1024, both routes, once:
   post_chunk_timings); the parent's time beside each), each plain version
   once. Each kernel's bound is the larger
   of its FP32 operations (counted a cell from its source) at 67 TFLOP/s
   and the bytes it must move (each input once, each output once) at 3.35
   TB/s, at the timed shape;
11. database-scale paths, on phase 9's database and profiles: `--stream
   4096` against the whole-file run, in turns, for `scan --stage search
   --domains` (also byte-equal to phase 9's report; every planted row a
   hit), `scan`, `scan --stage search --fast`, `sweep` and `sweep --stage
   search --fast` over the 24 profiles: every report byte-equal, the 4
   batches staged on a side stream other than the consumer's (the stager's
   log line), the MSV kernel launched once a batch at least, the phase line
   (producer/parse, /encode, /stage, /put_wait, prefetch_wait) and both end
   to end times printed; `--bucketed` against the unbucketed run on a
   length-skewed FASTA (16384 sequences, lengths from a seeded lognormal of
   median 300 and sigma 1.0 clipped to 10..10000) for `scan`, `scan
   --stage search [--fast]` and `sweep`: reports byte-equal, the bucket
   count, padded cells saved and both runs' seconds printed; `sweep
   --checkpoint DIR --checkpoint-shard 4096` (msv, and `--stage search
   --fast`): the report byte-equal to phase 9's sweep, then one profile's
   chunk of shard 2 and every chunk of shard 3 deleted and the sweep rerun:
   the report byte-equal again and only the deleted chunks recomputed (the
   checkpoint's log lines, every other chunk file untouched);
12. the host subcommands and alignments, each CLI run with every launch
   count set to 0 just before it and read just after: `emit` BUILD_SAMPLES
   samples of 1400.hmm, `align --format stockholm` them and `build` the MSA
   with --device cuda (the MSV, eager Viterbi and log-space Forward kernels
   each launched) and --device cpu: the files equal apart from the STATS
   lines, which agree within MU_TOL (MSV and Viterbi mu) and TAU_TOL
   (Forward tau) bits; the card's calibration traced (its kernel time and
   busy share); calibrate_profile on the LENG 4770 join (the three wide
   cases, held against plain in phase 8) and on the LENG 6977 and 30181
   joins (MSV's 3- and 13-block clusters, the eager and log-space wide
   block and cluster of 4 wide blocks, none in memory; their seconds, and
   their STATS within MU_TOL / TAU_TOL of the same calibration through the
   plain versions on the card); on phase 9's database `scan --stage
   search --align --msa-out` (every planted row a hit with an alignment
   inside its sequence, the MSA a row a domain), with --domains (the
   envelope rows kept, the alignments unchanged) and with --stream 4096
   (report and MSA byte-equal to the whole-file run); `--config` with msv_p
   CONFIG_MSV_P (the survivor counts of SearchPipeline(msv_p=CONFIG_MSV_P)
   on the same batch); `scan --stage search --domains --profile-trace DIR`
   (the kernels' device events under their symbol names, every phase
   labelled, the device busy share of the labelled window printed); `info
   --hmm-dir --consensus`, `emit` and `generate` once each;
13. the device mesh (the card's count, name and power limit first), each
   path with every launch count set to 0 just before it and read just
   after: MSVScanner(mesh=) on a db = MESH_DB mesh naming the card
   MESH_DB times, on phase 9's database, every stage (B1, B2, B3 over the
   24 profiles; B7, B4 on 1400.hmm without e_skip_d, B5 and B6 on its
   first STAGE_BATCH rows; B9 and B10 through posterior_coverage_batch(
   mesh=)) equal to the single-device scanner's bit for bit, and
   top_k_hits equal to torch.topk; the sp wavefront (db = 1 and db = 2,
   sp = MESH_SP) on phase 11's skewed database with PLANTED homologs of
   1400.hmm: MSV, Viterbi (lazy, and eager without e_skip_d; db = 1) and
   Forward (db = 1) equal to one call, SeqblockScanner under SearchPipeline
   the single-device search field for field, every homolog a hit; the
   CLI: `scan --mesh db=1`, `--mesh all`, `--config` with use_mesh,
   `--stage search --domains --mesh db=1`, `sweep --mesh db=1`, `scan
   --stream 4096 --mesh db=1`, each byte-equal to its meshless report,
   and `--mesh db=2` exit 2 on one card (byte-equal on two or more);
   parallel.dryrun.dryrun_multichip(8); best-of-3 times of the one-card
   db mesh against the single scanner (B1, the --domains search) and of
   the sp wavefront against one call (B1, B7, B5), with their launches;
14. fuzzed profiles (FUZZ_SEEDS of the JAX suite's generator, the port's
   copy models/fuzz.py) through every kernel against its plain version on
   a ragged batch (B1-B10, B4 and B6 also without e_skip_d, B3 over all
   of them);
15. the fused cascade on phase 9's database, each CLI run with every launch
   count set to 0 just before it and read just after: `scan --stage search
   --fused` (B2, B1, B6, B7 and B5 launched once each and nothing else, the
   search line's `(fused)`, the report byte-equal to phase 9's `--fast`
   report, the hits phase 9's search's), `--fused --domains` (the hit rows
   phase 9's `--domains` report's, every planted row a hit with its
   envelope inside it), `--fused --stream 4096` (byte-equal to the
   whole-file `--fused` report, the fused cascade on each of the 4
   batches), `--fused --bucketed` exit 2; FUSED_OVERFLOW consensus copies of
   1400.hmm through SearchPipeline(fused=True) (the capacity overflow
   logged, the staged cascade's result); the fused chain of a warm search
   enqueued under torch.cuda.set_sync_debug_mode("error"), the host's
   enqueue time and the survivor counts n1, n2, n3 printed; best-of-3
   times of the fused search and the staged `--fast` search on one staged
   batch, by the host clock around `search` and by CUDA events around each
   stage's scan (the results equal field for field), beside the card's
   name and power limit;
16. the bench: `msv_scores` (the one-call MSV entry of ref_1400_b3 and
   e2e_1400) on 8 ragged sequences of 1400.hmm and 2405.hmm equal to its
   plain version and the oracle; then `python -m
   hmm_fasta_viterbi_tpu_torch.bench --e2e` in-process at its defaults
   (16384 x 3500, best of 3), every launch count set to 0 just before it
   and read just after: its line has no error and bench.py's rows in
   bench.py's order under `_cuda`, and B1, B2, B3, B5, B6, B7, B9 and B10
   are each launched; its JSON line and each row's GCUPS and ms are
   printed, and the headline's wall-clock ms against phase 10's CUDA-event
   ms for B1 at the same shape.

Prints a JSON line about the kernels (every case, the wide ones as
`<kernel>_wide`, the C-block clusters past 4864 states (the MSV kernels',
the lazy Viterbi's, the Viterbi filter's, Forward's and the row-saving
Forward's) as `<kernel>_cluster`, the eager and log-space wide block as
`<kernel>_block` and their clusters of wide blocks as `<kernel>_blocks`,
the clusters of 256-thread blocks past 38,912 states (Forward's, the
posterior pair's, the Viterbi filter's, the MSV kernels') as
`<kernel>_cluster256`, the rows-in-memory ones as `<kernel>_mem`), then the card's
name and power limit and, last,
{"ok": true, ...}. Any failed check raises, and the script exits
non-zero without those lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import logging
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hmm_fasta_viterbi_tpu_torch.io.alphabet import AMINO_ACIDS
from hmm_fasta_viterbi_tpu_torch.io import native
from hmm_fasta_viterbi_tpu_torch.io.fastaio import FastaRecord, write_fasta
from hmm_fasta_viterbi_tpu_torch.io.loader import load_profile
from hmm_fasta_viterbi_tpu_torch.models.sample import sample_sequences
from hmm_fasta_viterbi_tpu_torch import (
    MSVProfile, MSVScanner, P7Profile, forward_oracle_batch, msv_oracle_batch, parse_hmm,
    posterior_match, viterbi_oracle_batch,
)
from hmm_fasta_viterbi_tpu_torch import cli, convert
from hmm_fasta_viterbi_tpu_torch.bench.__main__ import main as bench_main
from hmm_fasta_viterbi_tpu_torch.io.loader import load_fasta
from hmm_fasta_viterbi_tpu_torch.io.msaio import read_msa
from hmm_fasta_viterbi_tpu_torch.models.build import calibrate_profile
from hmm_fasta_viterbi_tpu_torch.models.fuzz import random_profile
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda, p7_cuda, posterior_cuda
from hmm_fasta_viterbi_tpu_torch.parallel.database import top_k_hits
from hmm_fasta_viterbi_tpu_torch.parallel.dryrun import dryrun_multichip
from hmm_fasta_viterbi_tpu_torch.parallel.mesh import make_scan_mesh
from hmm_fasta_viterbi_tpu_torch.parallel.seqblocks import (
    SeqblockScanner, block_length, msv_scan_seqblocks, p7_scan_seqblocks,
)
from hmm_fasta_viterbi_tpu_torch.pipeline import (
    SearchPipeline, forward_scores, fused_cascade, fused_caps, msv_scores,
    viterbi_filter_scores, viterbi_scores,
)
from hmm_fasta_viterbi_tpu_torch.runtime import profiling

REPO = pathlib.Path(__file__).resolve().parent
PROFILES = REPO / "data" / "profile_HMMs"
DEVICE = "cuda:0"
SEED = 0
# bench.py's headline batch: 16384 random sequences of 3500 residues
BATCH, SEQ_LEN = 16384, 3500
# the MSV ragged batch of the 24-profile check, and its carry-chain split
# (not a multiple of 32, the kernel's token group)
RAGGED_BATCH, RAGGED_LEN, SPLIT = 300, 600, 257
# the proteome cell's configuration: its row lengths, for the bucketed MSV
# stage's check
PROTEOME_CONFIG = REPO / "hmmbench" / "configs" / "pfam_scan_proteome.json"
# the Viterbi/Forward ragged batch and its split: a multiple of the
# Forward rescale group, not of the kernels' 128-residue chunk
P7_BATCH, P7_SPLIT = 64, 200
# the bench's Viterbi/Forward stage shape (viterbi_1400, forward_1400)
STAGE_BATCH = 4096
# the cascade's survivor batch (33 rows reach Viterbi on the CLI database),
# rounded up: <kernel>_1400_b64
SURVIVOR_BATCH = 64
PLANTED = 32
VIT_TOL, FWD_TOL = 1e-4, 2e-3
# the log-space Forward kernel against its plain version (the same
# semiring; expf/log1pf and the E sum round differently on the card)
LOG_FWD_TOL = 1e-4
# posterior coverage and totals (the forward rows are bf16)
COV_TOL, TOT_TOL = 4e-3, 2e-3
# the posterior ragged batch of the 24-profile check
POST_BATCH, POST_LEN = 16, 300
# validate_hw.py's long-sequence drift check: the probability-space Forward
# against the log-space referee on one sequence of 100.hmm
LONG_L, LONG_TOL = 36864, 5e-3
# the bench's posterior shape (posterior_1400, posterior_mask_1400)
POST_TIME_BATCH, POST_TIME_LEN = 1024, 1024
# the profiles wider than 2432 states, each joined from two of the repo's
# (LENG 2701 and 4770), and the ragged batch they are checked on
WIDE_PAIRS = (("1400", "1301"), ("2405", "2365"))
WIDE_BATCH, WIDE_LEN = 8, 300
# the profiles past 4864 states (the rows-in-memory cases), joined from the
# repo's: 2405.hmm, 2365.hmm and 2207.hmm (LENG 6975), and all 24 (LENG
# 30160, 15 chain passes), checked on the same ragged batch
MEM_JOINS = (("2405", "2365", "2207"), tuple(
    sorted((p.stem for p in PROFILES.glob("*.hmm")), key=int)))
# the MSV kernel's C-block clusters (C = ceil(M_pad / 2432)): MEM_JOINS land
# on C = 3 and 13; these joins of the repo's largest profiles on C = 5, 8
# and 9 (LENG 11165, 18170, 19679); past 38,912 states the MSV kernel's
# 16-block cluster of 8-warp blocks takes the all-24 join twice over (LENG
# 60362), held and timed at MSV_MEM_BATCH rows
CLUSTER_JOINS = (("2405", "2365", "2207", "2138", "2050"),
                 ("2405", "2365", "2207", "2138", "2050", "1901", "1799", "1705", "1600"),
                 ("2405", "2365", "2207", "2138", "2050", "1901", "1799", "1705", "1600", "1509"))
CLUSTER_SIZES = (3, 13, 5, 8, 9)  # of MEM_JOINS + CLUSTER_JOINS, in that order
MSV_MEM_JOIN = MEM_JOINS[1] * 2
MSV_MEM_BATCH = 256
# the rows-in-memory main path: MEM_BATCH random rows of MEM_LEN residues
# with MEM_PLANTED homologs of the three-profile join at known rows; each
# rows-in-memory case is timed once at MEM_TIME_LEN residues (MSV at
# WIDE_MSV_BATCH rows, the p7 kernels at SURVIVOR_BATCH)
MEM_BATCH, MEM_LEN, MEM_PLANTED = 2048, 600, 4
MEM_TIME_LEN = 1000
# the rows of the fast search past 38,912 states (every one past MSV)
FAST_PAST_ROWS = 64
# homologs of the wider profile planted in the CLI database, and the batch the
# wide MSV cases are timed at
WIDE_PLANTED = 4
WIDE_MSV_BATCH = 2048
# copies of one profile stacked in the MSV plan check: 132 // STRIDE_COPIES
# blocks a profile, so that every warp walks several sequences of the
# ragged batch
STRIDE_COPIES = 44
# phase 11: the streamed batch (4 batches of the headline database), the
# checkpoint shard, and the length-skewed database of the bucketed runs
STREAM_BATCH = 4096
CHECKPOINT_SHARD = 4096
SKEW_BATCH, SKEW_MEDIAN, SKEW_SIGMA, SKEW_CLIP = 16384, 300, 1.0, (10, 10000)
# phase 12: the samples of 1400.hmm that `build` estimates a profile from;
# its STATS against the plain versions' (bits: MSV and Viterbi mu, and
# Forward tau, Forward's tolerance through nats_to_bits and the 96th
# percentile); the MSV threshold of the `--config` search (HMMER3's is 0.02)
BUILD_SAMPLES = 64
MU_TOL, TAU_TOL = 1e-3, 5e-3
CONFIG_MSV_P = 0.05
# the kernels build's calibration runs (B1, B4, B8)
CALIBRATION_KERNELS = ("msv_scan", "viterbi_scan", "forward_log_scan")
# phase 13: the db axis of the one-card mesh ([cuda:0] * 4), and the sp
# axis of the wavefront meshes (db = 1 and db = 2)
MESH_DB, MESH_SP = 4, 4
# phase 14: (seed, LENG bound) of tests/test_fuzz_differential.py's
# profiles (MSV 100-102 below 60, p7 200-201 and filter 300-301 below 40,
# posterior 400 below 30) and the ragged batch they run on
FUZZ_SEEDS = ((100, 60), (101, 60), (102, 60), (200, 40), (201, 40), (300, 40), (301, 40),
              (400, 30))
FUZZ_BATCH, FUZZ_LEN = 32, 300
# phase 15: the JAX suite's overflow batch (consensus copies of the profile:
# every row survives every stage, past cap1 = 128 at this B)
FUSED_OVERFLOW = 200

# the card's published peaks (NVIDIA H100 SXM data sheet): FP32 outside the
# tensor cores and HBM3 bandwidth, for each kernel's bound
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

# phase 10's wide cases and cases past 4864 states at an earlier commit:
# the wide rows and the eager and log-space rows to 9216 states at 1800209
# (before the eager and log-space wide block), the faster of its two runs
# of tools/torch_wide_timing.py (at its defaults, and with --block: the
# rows-in-memory case there) on its `git archive`, in one call on
# PARENT_CARD with the next tree's two runs between them; the eager and
# log-space rows past 9216 at 8d113fb (before their clusters of wide
# blocks), as said below; the other rows past 4864 are 1800209's final
# chip_smoke.py run (PERF.md §6, the same card model)
PARENT_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PARENT_WIDE_MS = {
    "msv_scan_wide": 6.376, "msv_filter_scan_wide": 6.331, "msv_stacked_scan_wide": 10.596,
    "viterbi_lazy_scan_wide": 9.204, "viterbi_scan_wide": 60.41,
    "viterbi_filter_scan_wide": 8.954, "forward_log_scan_wide": 228.23,
    "forward_prob_scan_wide": 14.388, "forward_save_scan_wide": 4.503,
    "backward_coverage_scan_wide": 4.752,
    "msv_scan_cluster": 3.869, "msv_filter_scan_cluster": 3.867,
    "msv_stacked_scan_cluster": 21.799,
    "msv_scan_mem": 74.714, "msv_filter_scan_mem": 72.806, "msv_stacked_scan_mem": 74.609,
    "viterbi_lazy_scan_cluster": 5.565, "viterbi_filter_scan_cluster": 5.856,
    "forward_prob_scan_cluster": 9.957, "forward_save_scan_cluster": 10.721,
    "backward_coverage_scan_cluster": 10.988,
    "viterbi_lazy_scan_cluster_30181": 69.063, "viterbi_filter_scan_cluster_30181": 80.71,
    "forward_prob_scan_cluster_30181": 95.764, "forward_save_scan_cluster_30181": 106.307,
    "backward_coverage_scan_cluster_30181": 100.508,
    "viterbi_lazy_scan_mem": 501.385, "viterbi_filter_scan_mem": 311.669,
    "forward_prob_scan_mem": 335.946, "forward_save_scan_mem": 353.977,
    "backward_coverage_scan_mem": 332.131,
    # the rows-in-memory case before the wide block at LENG 6977 (64 x 1000,
    # and build's calibration shape, 256 x 400)
    "viterbi_scan_block": 29.226, "forward_log_scan_block": 56.56,
    "viterbi_scan_block_cal": 27.085, "forward_log_scan_block_cal": 55.77,
    # the parent 8d113fb's rows-in-memory case past 9216, in turns with this
    # tree on the card (tools/torch_wide_timing.py --block on its `git
    # archive`, the faster of its two runs): LENG 30181 at 64 x 1000 (the
    # clusters of 4 wide blocks, and this tree's rows-in-memory route,
    # `_mem`) and 256 x 400, LENG 60362 at 64 x 1000 (8 wide blocks)
    "viterbi_scan_blocks_30181": 233.614, "forward_log_scan_blocks_30181": 328.17,
    "viterbi_scan_mem": 233.614, "forward_log_scan_mem": 328.17,
    "viterbi_scan_blocks_cal": 249.513, "forward_log_scan_blocks_cal": 317.13,
    "viterbi_scan_blocks": 520.229, "forward_log_scan_blocks": 706.128,
    # the parent a7addf8's rows-in-memory case of the posterior pair past
    # 38,912 states (LENG 60362, 64 x 1024), its final chip_smoke.py run on
    # PARENT_CARD, before their clusters of 256-thread blocks
    "forward_save_scan_cluster256": 355.919, "backward_coverage_scan_cluster256": 337.563,
    # the parent a59689b's rows-in-memory case of the lazy Viterbi and
    # Forward past 38,912 states (LENG 60362, 64 x 1000), its final
    # chip_smoke.py run on PARENT_CARD, before the lazy kind's cluster of
    # wide blocks and Forward's cluster of 256-thread blocks
    "viterbi_lazy_scan_blocks": 501.385, "forward_prob_scan_cluster256": 335.946,
    # the parent b7e4997's rows-in-memory case of MSV (LENG 60362, 256 x
    # 1000) and the Viterbi filter (64 x 1000) past 38,912 states, before
    # their clusters of 256-thread blocks (PERF.md, section 6)
    "msv_scan_cluster256": 74.714, "msv_filter_scan_cluster256": 72.806,
    "msv_stacked_scan_cluster256": 74.609, "viterbi_filter_scan_cluster256": 311.669,
}

# the sweep timing batch (sweep24, sweep24_filter) and the profiles the plain
# filter sweep is timed on (every fourth, scaled to all 24 by cells)
SWEEP_BATCH = 8192
PLAIN_SWEEP_EVERY = 4

# name: (source, TPU kernel body file:line, the body's mode)
KERNELS = {
    "msv_scan": ("csrc/msv_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_msv.py:100",
                 "exact, one profile"),
    "viterbi_scan": ("csrc/p7_viterbi_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:166",
                     "Viterbi (eager)"),
    "viterbi_lazy_scan": ("csrc/p7_viterbi_kernel.cu",
                          "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:923", "lazy Viterbi"),
    "forward_prob_scan": ("csrc/p7_forward_kernel.cu",
                          "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:474",
                          "probability-space Forward"),
    "msv_filter_scan": ("csrc/msv_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_msv.py:100",
                        "filter: exact=False, skip_row0_guard=True (bf16 round-up table)"),
    "msv_stacked_scan": ("csrc/msv_kernel.cu", "hmm_fasta_viterbi_tpu/ops/pallas_msv.py:100",
                         "profile stack: grid dimension P > 1 (exact and filter)"),
    "viterbi_filter_scan": ("csrc/p7_viterbi_filter_kernel.cu",
                            "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:682",
                            "upper-bound Viterbi filter (a case of csrc/p7_viterbi.cuh)"),
    "forward_log_scan": ("csrc/p7_forward_log_kernel.cu",
                         "hmm_fasta_viterbi_tpu/ops/pallas_p7.py:166",
                         "log-space Forward (forward=True)"),
    "forward_save_scan": ("csrc/p7_forward_kernel.cu",
                          "hmm_fasta_viterbi_tpu/ops/pallas_posterior.py:97",
                          "posterior forward pass: bf16 rows and log scales saved"),
    "backward_coverage_scan": ("csrc/p7_backward_kernel.cu",
                               "hmm_fasta_viterbi_tpu/ops/pallas_posterior.py:225",
                               "posterior backward pass emitting coverage (a blocked p7 case)"),
}
WRAPPERS = {
    "msv_scan": msv_cuda.msv_scan_cuda,
    "viterbi_scan": p7_cuda.viterbi_scan_cuda,
    "viterbi_lazy_scan": p7_cuda.viterbi_lazy_scan_cuda,
    "forward_prob_scan": p7_cuda.forward_prob_scan_cuda,
    "msv_filter_scan": msv_cuda.msv_filter_scan_cuda,
    "msv_stacked_scan": msv_cuda.msv_stacked_scan_cuda,
    "msv_table_scan": msv_cuda.msv_table_scan_cuda,
    "viterbi_filter_scan": p7_cuda.viterbi_filter_scan_cuda,
    "forward_log_scan": p7_cuda.forward_log_scan_cuda,
    "forward_save_scan": posterior_cuda.forward_save_scan_cuda,
    "backward_coverage_scan": posterior_cuda.backward_coverage_scan_cuda,
}
# every case from 2433 to 4864 states (the cluster pairs: two warps a
# sequence for MSV, two 128-thread groups for the p7 kinds): a line of its
# own in the JSON, its launches counted by the same wrapper's wide_launches
WIDE = "_wide"
# the cases from 4865 to 38,912 states on C-block clusters (C = 3..16): the
# MSV kernels' (C warps a sequence) and the lazy Viterbi's, the Viterbi
# filter's, Forward's, the row-saving Forward's and the backward pass's (C
# groups of 128 threads a sequence): their own JSON lines, their launches
# counted by the wrapper's cluster_launches at every C past 2
CLUSTER = "_cluster"
MSV_WRAPPERS = ("msv_scan", "msv_filter_scan", "msv_stacked_scan")
P7_CLUSTER_WRAPPERS = ("viterbi_lazy_scan", "viterbi_filter_scan", "forward_prob_scan",
                       "forward_save_scan", "backward_coverage_scan")
CLUSTER_WRAPPERS = MSV_WRAPPERS + P7_CLUSTER_WRAPPERS
# every case past 4864 states (those of CLUSTER_WRAPPERS: past 38,912; the
# rows-in-memory cases: one 1024-thread block a sequence, the DP rows in
# global memory): its own JSON line, its launches counted by the wrapper's
# mem_launches
MEM = "_mem"
# the eager Viterbi's and the log-space Forward's cases past 4864 states up
# to p7_cuda.MAX_BLOCK_STATES (the wide block: one 1024-thread block a
# sequence, the rows in registers): their own JSON lines, their launches
# counted by the wrapper's block_launches; past that (up to 65536) their
# clusters of C = 2..8 wide blocks (`_blocks`, launches summed from the
# wrapper's block_cluster_launches, a dict by C); their rows-in-memory case
# (`_mem`) is the route of a card that holds no such cluster, driven with
# the occupancy query answering 0 (no_block_clusters) at LENG 30181
BLOCK = "_block"
BLOCKS = "_blocks"
BLOCK_WRAPPERS = ("viterbi_scan", "forward_log_scan")
# the wrappers with clusters of wide blocks: the two above past 9216 states
# and, past 38,912, the lazy Viterbi (its whole-chain step); the lazy kind's
# rows-in-memory case (`_mem`) is the route of a card that holds no such
# cluster, driven with no_block_clusters at LENG 60362
BLOCKS_WRAPPERS = BLOCK_WRAPPERS + ("viterbi_lazy_scan",)
# Forward's, the row-saving Forward's, the backward pass's and the Viterbi
# filter's cases past 38,912 states (up to 65536): C-block clusters of
# p7_cuda.WIDE_CLUSTER_THREADS-thread blocks, C = 9..14; and the MSV
# kernels' there: 16-block clusters of msv_cuda.WIDE_CLUSTER_WARPS = 8 warps
# (256 threads) a block: their own JSON lines, their launches summed from
# the wrapper's block_cluster_launches (a dict by C); their rows-in-memory
# case (`_mem`) is the route of a card that holds no such cluster, driven
# with the occupancy query answering 0 (no_block_clusters) at LENG 60362
CLUSTER256 = "_cluster256"
P7_CLUSTER256_WRAPPERS = ("forward_prob_scan", "forward_save_scan", "backward_coverage_scan",
                          "viterbi_filter_scan")
CLUSTER256_WRAPPERS = P7_CLUSTER256_WRAPPERS + MSV_WRAPPERS
# build's calibration shape (models/build.py::calibrate_profile at LENG >=
# 400): the wide block timed there too (`<kernel>_block_cal`)
CAL_BATCH, CAL_LEN = 256, 400
MAX_BLOCK = p7_cuda.MAX_BLOCK_STATES


def mem_states(name: str) -> int:
    """The states past which ``name``'s kernel runs a rows-in-memory case
    on a card that holds none of its clusters (MSV past 65536 on any
    card)."""
    if name == "viterbi_lazy_scan":
        return p7_cuda.LAZY_BLOCK_STATES
    return msv_cuda.MAX_CLUSTER_STATES if name in CLUSTER_WRAPPERS else MAX_BLOCK


KERNELS.update({
    **{name + WIDE: (source, replaces, f"{mode}; M_pad 2440..4864")
       for name, (source, replaces, mode) in KERNELS.items()},
    **{name + CLUSTER: (source, replaces, f"{mode}; M_pad 4872..38912, C-block clusters")
       for name, (source, replaces, mode) in KERNELS.items() if name in CLUSTER_WRAPPERS},
    **{name + BLOCK: (source, replaces, f"{mode}; M_pad 4872..{p7_cuda.MAX_BLOCK_STATES}, "
                      f"the wide block ({p7_cuda.BLOCK_THREADS} threads a sequence)")
       for name, (source, replaces, mode) in KERNELS.items() if name in BLOCK_WRAPPERS},
    **{name + BLOCKS: (source, replaces, (
        f"{mode}; M_pad {MAX_BLOCK + 8}..{p7_cuda.MAX_KERNEL_STATES}, clusters of "
        f"2..{p7_cuda.MAX_BLOCK_CLUSTER} wide blocks" if name in BLOCK_WRAPPERS else
        f"{mode}; M_pad {p7_cuda.LAZY_BLOCK_STATES + 8}..{p7_cuda.MAX_KERNEL_STATES}, clusters "
        f"of 5..{p7_cuda.MAX_BLOCK_CLUSTER} wide blocks, the whole 16-pass chain"))
       for name, (source, replaces, mode) in KERNELS.items() if name in BLOCKS_WRAPPERS},
    **{name + CLUSTER256: (source, replaces, f"{mode}; M_pad {msv_cuda.MAX_CLUSTER_STATES + 8}.."
                           f"{p7_cuda.MAX_KERNEL_STATES}, " + (
                               f"16-block clusters of {msv_cuda.WIDE_CLUSTER_WARPS}-warp blocks"
                               if name in MSV_WRAPPERS else
                               f"C-block clusters of {p7_cuda.WIDE_CLUSTER_THREADS}-thread "
                               "blocks"))
       for name, (source, replaces, mode) in KERNELS.items() if name in CLUSTER256_WRAPPERS},
    **{name + MEM: (source, replaces, f"{mode}; M_pad past {mem_states(name)}, "
                    "rows in global memory" + (
                        " (a card that holds no cluster of wide blocks)" if name in BLOCKS_WRAPPERS
                        else " (a card that holds no cluster of 256-thread blocks; MSV past "
                        f"{msv_cuda.MAX_WIDE_CLUSTER_STATES} on any)"
                        if name in CLUSTER256_WRAPPERS else ""))
       for name, (source, replaces, mode) in KERNELS.items()},
})


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; equal infinities count as 0, unequal ones as inf."""
    a, b = a.double().cpu(), b.double().cpu()
    same = a == b
    if bool(same.all()):
        return 0.0
    return float((a - b).abs()[~same].max())


def require_equal(got, want, what: str) -> float:
    err = max(max_abs_diff(g, w) for g, w in zip(got, want))
    require(all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)),
            f"{what}: not equal, max |d| {err}")
    return err


def require_geq(upper, lower, what: str) -> None:
    """upper >= lower on every sequence (both -inf for an empty one)."""
    upper, lower = upper.cpu(), lower.cpu()
    ok = (upper >= lower) | (torch.isneginf(upper) & torch.isneginf(lower))
    require(bool(ok.all()), f"{what}: filter below exact on {int((~ok).sum())} sequences")


def stems() -> list[str]:
    found = sorted((p.stem for p in PROFILES.glob("*.hmm")), key=int)
    require(len(found) == 24, f"24 profiles, found {len(found)}")
    return found


def profile(stem: str) -> MSVProfile:
    return MSVProfile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))


def p7_profile(stem: str) -> P7Profile:
    return P7Profile.from_profile(parse_hmm(PROFILES / f"{stem}.hmm"))


def join_profiles(first, *rest):
    """One profile HMM whose match nodes are ``first``'s and then each of
    ``rest``'s in turn (ProfileHMMs of either package: the same fields).
    Each joint node, the last of the profile before it, takes the
    transitions of the node before it (a last node has none onward); the
    rest, and the STATS lines, are ``first``'s."""
    joined = first
    for second in rest:
        trans = np.concatenate([joined.transitions, second.transitions[1:]]).copy()
        trans[joined.model_length - 1] = joined.transitions[joined.model_length - 2]
        joined = dataclasses.replace(
            joined, name=f"{joined.name}+{second.name}",
            model_length=joined.model_length + second.model_length - 1,
            match_emissions=np.concatenate([joined.match_emissions,
                                            second.match_emissions[1:]]),
            insert_emissions=np.concatenate([joined.insert_emissions,
                                             second.insert_emissions[1:]]),
            transitions=trans)
    return joined


@functools.cache
def wide_profile(stems_: tuple[str, ...]):
    """The wide profile of WIDE_PAIRS or MEM_JOINS built from the repo's
    profiles ``stems_``, joined in that order (built once a process: the
    LENG 60362 join takes seconds; no caller changes it)."""
    return join_profiles(*(parse_hmm(PROFILES / f"{stem}.hmm") for stem in stems_))


def format_hmm(hmm) -> str:
    """HMMER3 text of a ProfileHMM as the parsers read it back: probabilities
    as negative natural logs (5 decimals), 0 as '*', the last node's m->d and
    d->d as '*'."""

    def fields(probs):
        return "  ".join("        *" if p <= 0.0 else f"{max(-math.log(p), 0.0):9.5f}"
                         for p in np.asarray(probs, dtype=np.float64))

    leng = hmm.model_length - 1
    lines = [
        "HMMER3/b [chip_smoke]", f"NAME  {hmm.name}", f"LENG  {leng}", "ALPH  amino",
        f"STATS LOCAL MSV      {hmm.stats_local_msv_mu:9.4f}  {hmm.stats_local_msv_lambda:.5f}",
        f"STATS LOCAL VITERBI  {hmm.stats_local_viterbi_mu:9.4f}  "
        f"{hmm.stats_local_viterbi_lambda:.5f}",
        f"STATS LOCAL FORWARD  {hmm.stats_local_forward_theta:9.4f}  "
        f"{hmm.stats_local_forward_lambda:.5f}",
        "HMM    " + "  ".join(f"{a:>9s}" for a in AMINO_ACIDS),
        "        m->m     m->i     m->d     i->m     i->i     d->m     d->d",
        f"  COMPO  {fields(np.asarray(hmm.match_emissions[1:], dtype=np.float64).mean(axis=0))}",
        f"         {fields(hmm.insert_emissions[0])}",
        f"         {fields(hmm.transitions[0])}",
    ]
    for k in range(1, hmm.model_length):
        trans = np.asarray(hmm.transitions[k], dtype=np.float64).copy()
        if k == leng:
            trans[[2, 6]] = 0.0
        lines += [f"{k:7d}  {fields(hmm.match_emissions[k])}  {k:7d} - -",
                  f"         {fields(hmm.insert_emissions[k])}", f"         {fields(trans)}"]
    return "\n".join(lines + ["//"]) + "\n"


def zero_launches() -> None:
    for fn in WRAPPERS.values():
        msv_cuda.zero_launches(fn)


def launches() -> dict:
    return {**{name: fn.launches for name, fn in WRAPPERS.items()},
            **{name + WIDE: fn.wide_launches for name, fn in WRAPPERS.items()},
            **{name + CLUSTER: sum(n for c, n in WRAPPERS[name].cluster_launches.items() if c > 2)
               for name in CLUSTER_WRAPPERS},
            **{name + BLOCK: WRAPPERS[name].block_launches for name in BLOCK_WRAPPERS},
            **{name + BLOCKS: sum(WRAPPERS[name].block_cluster_launches.values())
               for name in BLOCKS_WRAPPERS},
            **{name + CLUSTER256: sum(WRAPPERS[name].block_cluster_launches.values())
               for name in CLUSTER256_WRAPPERS},
            **{name + MEM: fn.mem_launches for name, fn in WRAPPERS.items()}}


def cluster_launches() -> dict:
    """The launches of the wrappers with C-block clusters in clusters, by C
    (the p7 ones' cluster pairs at C = 2 included), of the eager, log-space
    and lazy wrappers in clusters of wide blocks, by C, and of Forward's,
    the posterior pair's, the filter's and the MSV kernels' in clusters of
    256-thread blocks, by C."""
    return {**{name: dict(sorted(WRAPPERS[name].cluster_launches.items()))
               for name in CLUSTER_WRAPPERS},
            **{name + BLOCKS: dict(sorted(WRAPPERS[name].block_cluster_launches.items()))
               for name in BLOCKS_WRAPPERS},
            **{name + CLUSTER256: dict(sorted(WRAPPERS[name].block_cluster_launches.items()))
               for name in CLUSTER256_WRAPPERS}}


@contextlib.contextmanager
def no_block_clusters():
    """The card as one that holds no cluster of blocks wider than 128
    threads, nor MSV's 16-block cluster of 8-warp blocks: device_plan's and
    msv_cuda.device_case's occupancy queries answer 0 for them, so the eager
    and log-space kinds plan their rows-in-memory case past MAX_BLOCK and
    the lazy kind, Forward, the row-saving Forward, the backward pass, the
    Viterbi filter and MSV theirs past 38,912 (the route such a card takes,
    logged); every other query as the card answers it."""
    held = p7_cuda._cluster_held
    fits = msv_cuda._cluster_fits

    def query(kind, per, smem, index, cluster, threads=p7_cuda.KERNEL_THREADS):
        if threads in (p7_cuda.BLOCK_THREADS, p7_cuda.WIDE_CLUSTER_THREADS):
            return 0
        return held(kind, per, smem, index, cluster, threads)

    def msv_query(index, lanes, per, bf16):
        return not msv_cuda.wide_cluster_case(lanes, per) and fits(index, lanes, per, bf16)

    p7_cuda._cluster_held = query
    msv_cuda._cluster_fits = msv_query
    try:
        yield
    finally:
        p7_cuda._cluster_held = held
        msv_cuda._cluster_fits = fits


def with_groups(fn, groups):
    """``fn`` with its launch forced to ``groups`` sequences a block."""
    return lambda *args: fn(*args, groups=groups)


def passes_of(kind: str, pack) -> int:
    """Chain passes a step of a redesigned p7 case runs (its plan's key)."""
    if kind == "lazy":
        return pack.lazy_k
    if kind in ("forward", "save", "backward"):
        return pack.chain.shape[0]  # the backward pass's suffix window is the Forward's W
    if kind == "filter":
        return pack.window
    return p7_cuda.chain_passes(pack.m_pad)


def plan_text(kind: str, pack, batch: int) -> str:
    plan = p7_cuda.device_plan(kind, pack.m_pad, passes_of(kind, pack), batch, DEVICE)
    per = plan.per
    regs = p7_cuda.kernel_regs(kind, per, plan.threads, plan.cluster)
    pair = ""
    if plan.cluster > 1:
        most = p7_cuda.max_clusters(kind, per, plan.smem, torch.device(DEVICE).index or 0,
                                    plan.cluster, plan.threads)
        what = ("cluster of wide blocks" if plan.block_cluster else
                "C-block cluster of 256-thread blocks" if plan.wide_cluster else
                "cluster pair" if plan.cluster == p7_cuda.CLUSTER else "C-block cluster")
        pair = (f"{what}: {plan.cluster} blocks a cluster, {plan.grid // plan.cluster} "
                f"clusters (cudaOccupancyMaxActiveClusters {most}), ")
    return (f"{pair}{plan.threads} threads x {per}, G={plan.groups} (of {plan.max_groups}), grid="
            f"{plan.grid}, chain rows staged {plan.n_chain}/{passes_of(kind, pack)}, transition "
            f"rows staged {plan.n_trans}/6, dynamic smem {plan.smem} bytes, {regs} registers")


def p7_packs(p7: P7Profile, device) -> dict:
    """The pack of each blocked p7 kind (the log-space Forward takes the
    eager pack, the row-saving Forward and the backward pass the Forward's)."""
    packs = {"lazy": p7_cuda.viterbi_pack(p7, device, lazy=True),
             "eager": p7_cuda.viterbi_pack(p7, device, lazy=False),
             "forward": p7_cuda.forward_pack(p7, device),
             "filter": p7_cuda.filter_pack(p7, device)}
    packs["log"], packs["save"], packs["backward"] = (packs["eager"], packs["forward"],
                                                      packs["forward"])
    return packs


def print_plans(scanner) -> None:
    """Each blocked p7 case's launch plan against 1400.hmm, the wider wide
    profile and both joins past 4864 states (the C-block clusters of 3 and
    13 blocks, the wide block and the cluster of 4 wide blocks) at the timed
    shapes, and the posterior pair's against the all-24 join twice over
    (LENG 60362: the cluster of 13 256-thread blocks), also at the 26 rows of
    a posterior_coverage_batch chunk there, and the Viterbi filter's there
    (the same cluster)."""
    for hmm in (parse_hmm(PROFILES / "1400.hmm"), wide_profile(WIDE_PAIRS[1]),
                *mem_profiles()):
        prof = P7Profile.from_profile(hmm)
        name = f"{hmm.name[:40]} (M {prof.num_states})"
        for kind, pack in p7_packs(prof, scanner.device).items():
            posterior = kind in ("save", "backward")
            batches = (POST_TIME_BATCH if posterior else STAGE_BATCH, SURVIVOR_BATCH)
            for batch in batches:
                print(f"plan {kind} {name} x {batch} rows: {plan_text(kind, pack, batch)}")
    big = P7Profile.from_profile(msv_mem_profile())
    fpack = p7_cuda.forward_pack(big, scanner.device)
    for kind in ("save", "backward"):
        for batch in (SURVIVOR_BATCH, post_chunk(big)):
            print(f"plan {kind} all-24 join twice (M {big.num_states}) x {batch} rows: "
                  f"{plan_text(kind, fpack, batch)}")
    print(f"plan filter all-24 join twice (M {big.num_states}) x {SURVIVOR_BATCH} rows: "
          f"{plan_text('filter', p7_cuda.filter_pack(big, scanner.device), SURVIVOR_BATCH)}")


def post_chunk(p7: P7Profile, length: int = POST_TIME_LEN) -> int:
    """The sequences of one posterior_coverage_batch call at ``length``
    residues against ``p7`` (its bf16 rows under POST_BYTES)."""
    return posterior_cuda.POST_BYTES // (length * p7_cuda.default_m_pad(p7) * 2)


def msv_plan_text(emit: torch.Tensor, b_pad: int) -> str:
    """The MSV launch plan of a launch over ``emit`` ([20, M_pad] or [P, 20,
    M_pad]) and ``b_pad`` sequences, with its kernel's registers and spills."""
    num_p = emit.shape[0] if emit.dim() == 3 else 1
    m_pad = emit.shape[-1]
    lanes, per = msv_cuda.device_case(m_pad, emit.element_size(), emit.device)
    plan = msv_cuda.device_plan(m_pad, emit.element_size(), b_pad, num_p, emit.device)
    text = (f"{lanes} lanes x {per}, W={plan.warps} warps, grid={plan.grid} x P={num_p}, "
            f"dynamic smem {plan.smem} bytes")
    if plan.cluster > 1:
        most = msv_cuda.max_clusters(emit.device.index or 0, lanes, per,
                                     emit.dtype == torch.bfloat16)
        text = (f"cluster: {plan.cluster} blocks a cluster, {plan.grid // plan.cluster} "
                f"clusters a profile (cudaOccupancyMaxActiveClusters {most}), {text}")
    if lanes != msv_cuda.MEM_LANES:
        regs, local = msv_cuda.kernel_attrs(lanes, per, plan.warps, emit.dtype == torch.bfloat16)
        text += f", {regs} registers, {local} bytes spilled"
    return text


def print_msv_plans(scanner) -> None:
    """Each MSV register case's launch plan at the timed shapes: 1400.hmm and
    2405.hmm at BATCH rows, the wide profiles' cluster pairs and the joins'
    C-block clusters (C = 3, 13, 5, 8, 9) at WIDE_MSV_BATCH rows, the LENG
    60362 join's 16-block cluster of 8-warp blocks at MSV_MEM_BATCH, each
    stacked group of the sweep at SWEEP_BATCH, in both modes."""
    shapes = [(profile(stem), f"{stem}.hmm", BATCH) for stem in ("1400", "2405")]
    for hmm in wide_profiles() + cluster_profiles():
        prof = MSVProfile.from_profile(hmm)
        shapes.append((prof, f"{hmm.name[:40]} (M {prof.num_states})", WIDE_MSV_BATCH))
    big = MSVProfile.from_profile(msv_mem_profile())
    shapes.append((big, f"all-24 join twice (M {big.num_states})", MSV_MEM_BATCH))
    for prof, name, rows in shapes:
        m_pad = msv_cuda.round_up(prof.num_states, 8)
        for mode, (emit, _) in (("exact", msv_cuda.pack_profile(prof, m_pad, scanner.device)),
                                ("filter", msv_cuda.pack_profile_filter(prof, m_pad,
                                                                        scanner.device))):
            print(f"msv plan {name} {mode} x {rows} rows: {msv_plan_text(emit, rows)}")
    groups = {}
    for p in (profile(stem) for stem in stems()):
        groups.setdefault(msv_cuda.kernel_case(msv_cuda.round_up(p.num_states, 8)), []).append(p)
    for grp in groups.values():
        for mode in ("exact", "filter"):
            emit, _ = scanner._stacked_pack(tuple(grp), mode)
            print(f"msv plan sweep group {'+'.join(p.name for p in grp)} {mode} x "
                  f"{SWEEP_BATCH} rows: {msv_plan_text(emit, SWEEP_BATCH)}")


def best_ms(fn, reps: int) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def once_ms(fn):
    """One CUDA-event timing of ``fn``; returns (ms, result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# FP32 operations a DP cell (a residue against a match state) in each
# kernel's source: adds, multiplies, maxes and compares, a transcendental
# (expf, log1pf, logf) counted as one; passes = the chain passes run
OPS_PER_CELL = {
    "msv": lambda passes: 3,  # M = emit + max(M_{j-1}, B + tr); E max
    # pre_diag 5, M 2, I 4, M + tmd 1, chain 2 a pass, E 2
    "eager": lambda passes: 14 + 2 * passes,
    # M 2, I 4, M + tmd 1, chain 2 a pass, E 1, pre_diag 5, certificate 4
    "lazy": lambda passes: 17 + 2 * passes,
    # the eager step with a truncated chain, max(a0) 1 and the tail 1
    "filter": lambda passes: 16 + 2 * passes,
    # diag 5, M 2, I 4, M * tmd 1, chain 2 a pass, E 2 (and the row store)
    "forward": lambda passes: 14 + 2 * passes,
    # the eager step with every max a logaddexp (max, min, sub, exp, log1p,
    # add: 6): pre_diag 15, M 8, I 9, M + tmd 1, chain 7 a pass, E 10
    "log": lambda passes: 43 + 7 * passes,
    # coverage 2, memit 1, iemit 1, B sum 1, I 3, chain entry 2, chain 2 a
    # pass, M 6
    "backward": lambda passes: 16 + 2 * passes,
}


def bound(ops: float, moved: int) -> tuple[float, str]:
    """(least ms, the term that binds): FP32 operations at the card's
    published FP32 peak against bytes at its memory rate."""
    op_ms, byte_ms = ops / PEAK_FP32_OPS * 1e3, moved / PEAK_BYTES * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def template_args(mangled: str) -> list[str]:
    """The template arguments of a mangled kernel name's first ``I...E``
    list: ints, bools, float (f32) and unsigned short (bf16)."""
    out = []
    rest = mangled
    while rest and rest[0] != "E":
        m = re.match(r"L([ib])(\d+)E", rest)
        if m:
            out.append(m.group(2) if m.group(1) == "i" else ("false", "true")[int(m.group(2))])
            rest = rest[m.end():]
        elif rest[0] in "ft":
            out.append({"f": "f32", "t": "bf16"}[rest[0]])
            rest = rest[1:]
        else:
            break
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line a compiled kernel case from nvcc's -Xptxas -v output:
    registers, spill stores/loads and shared memory, and the seconds each
    source took."""
    lines = [line for line in log.splitlines() if line.startswith(("$ nvcc", "built "))]
    for entry in re.split(r"Compiling entry function ", log)[1:]:
        # the kernel's own name follows its length; the file's anonymous
        # namespace may hold the source's name too
        case = re.search(r"(?<=\d)(msv|viterbi|forward|filter|backward)"
                         r"((?:_mem|_bounded|_pair|_wide_cluster|_cluster|_block_cluster|_block)?)"
                         r"_kernel"
                         r"(?:I(\w+))?",
                         entry.split("'")[1])
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        if case and regs:
            args = f"<{','.join(template_args(case.group(3)))}>" if case.group(3) else ""
            lines.append(
                f"{case.group(1)}{case.group(2)}_kernel{args}: "
                f"{regs.group(1)} registers, spill "
                f"{spill.group(1) if spill else '?'}/{spill.group(2) if spill else '?'} bytes, "
                f"smem {smem.group(1) if smem else 0} bytes"
            )
    return lines


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)


# -- MSV (phases 4, 5) ---------------------------------------------------------

def msv_args(scanner, prof, staged, filter_mode: bool = False):
    """The arguments of one MSV scan of ``prof`` from the row-0 carry: the
    exact f32 pack, or with ``filter_mode`` the filter's bf16 one."""
    if filter_mode:
        emit, consts = msv_cuda.pack_profile_filter(
            prof, msv_cuda.round_up(prof.num_states, 8), scanner.device)
    else:
        emit, consts = convert.device_profile(prof, scanner.device)
    m, s = msv_cuda.init_carry(staged.tr_rows, emit.shape[1])
    return emit, staged.tokens, staged.lengths, staged.tr_rows, consts, m, s


MSV_FNS = {False: (msv_cuda.msv_scan_cuda, msv_cuda.msv_scan_plain, "MSV"),
           True: (msv_cuda.msv_filter_scan_cuda, msv_cuda.msv_filter_scan_plain, "MSV filter")}


def msv_compare(args, filter_mode: bool = False):
    """Kernel vs plain, bit for bit; returns (max |d|, the kernel's scores)."""
    cuda_fn, plain_fn, what = MSV_FNS[filter_mode]
    got = cuda_fn(*args)
    torch.cuda.synchronize()
    return require_equal(got, plain_fn(*args), f"{what} kernel vs plain"), got[0]


def msv_chain_error(args, filter_mode: bool = False) -> float:
    cuda_fn, _, what = MSV_FNS[filter_mode]
    emit, tokens, lengths, tr_rows, consts, m, s = args
    whole = cuda_fn(*args)
    first = cuda_fn(
        emit, tokens[:, :SPLIT].contiguous(), lengths.clamp(max=SPLIT), tr_rows, consts, m, s,
    )
    second = cuda_fn(
        emit, tokens[:, SPLIT:].contiguous(), (lengths - SPLIT).clamp(min=0),
        tr_rows, consts, first[1], first[2],
    )
    torch.cuda.synchronize()
    return require_equal(second, whole, f"{what} carry chain vs one call")


def msv_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    lengths = rng.integers(0, RAGGED_LEN + 1, size=RAGGED_BATCH).astype(np.int32)
    lengths[:12] = np.minimum([0, 1, 2, 31, 32, 33, 64, 96, 256, 257, 512, 600], RAGGED_LEN)
    tokens = rng.integers(0, 20, size=(RAGGED_BATCH, RAGGED_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    for stem in stems():
        prof = profile(stem)
        args = msv_args(scanner, prof, staged)
        err, exact = msv_compare(args)
        chain = msv_chain_error(args)
        f_args = msv_args(scanner, prof, staged, filter_mode=True)
        f_err, filt = msv_compare(f_args, filter_mode=True)
        f_chain = msv_chain_error(f_args, filter_mode=True)
        require_geq(filt, exact, f"{stem}.hmm MSV filter kernel vs MSV kernel")
        errors["msv_scan"] = max(errors["msv_scan"], err, chain)
        errors["msv_filter_scan"] = max(errors["msv_filter_scan"], f_err, f_chain)
        gap = (filt - exact)[torch.isfinite(exact)]
        print(f"MSV kernels vs plain {stem}.hmm: B={RAGGED_BATCH} L<={RAGGED_LEN} exact "
              f"max|d|={err} chain at {SPLIT} max|d|={chain}; filter max|d|={f_err} chain "
              f"max|d|={f_chain}; filter - exact in [{float(gap.min()):.4f}, "
              f"{float(gap.max()):.4f}] nats")

    # one stacked launch per register case over all 24 profiles, both modes
    profs = [profile(stem) for stem in stems()]
    for mode, single in (("exact", scanner.scan), ("filter", scanner.scan_filter)):
        res = scanner.scan_many(profs, staged, mode=mode)
        err = 0.0
        for p in profs:
            want = single(p, staged)
            err = max(err, max_abs_diff(torch.from_numpy(res[p.name]), want))
            require(np.array_equal(res[p.name], want.cpu().numpy()),
                    f"stacked {mode} scan of {p.name} vs its single-profile kernel")
        errors["msv_stacked_scan"] = max(errors["msv_stacked_scan"], err)
        groups = len({msv_cuda.kernel_case(msv_cuda.round_up(p.num_states, 8)) for p in profs})
        print(f"stacked MSV kernel ({mode}): {len(profs)} profiles in {groups} launches == the "
              f"single-profile kernels (max|d|={err})")
    msv_plans_vs_default(scanner, staged, errors)
    table_scan_vs_plain(scanner)


def proteome_database(rows: np.ndarray | None = None, seed: int = SEED):
    """The proteome configuration's lengths (PROTEOME_CONFIG through
    ``hmmbench.traffic.generator.config_lengths``: its lognormal fit's
    quantiles and its four longest entries), those at ``rows`` of them
    where given, in a seeded order, and seeded random residues -> (tokens
    [B, longest] int8, lengths [B] int32)."""
    from hmmbench.traffic import generator

    lengths = generator.config_lengths(json.loads(PROTEOME_CONFIG.read_text())).astype(np.int32)
    if rows is not None:
        lengths = lengths[rows]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 20, size=(lengths.size, int(lengths.max())), dtype=np.int8)
    return tokens, rng.permutation(lengths)


def table_scan_vs_plain(scanner) -> None:
    """The bucketed MSV stage over the proteome configuration's rows:
    scan_bucketed (exact and filter) of 100.hmm, 1400.hmm and 2405.hmm (the
    register cases of PER 4, 44 and 76) is one launch of the row table
    kernel a call, counted from zero and nothing else launched, one scan
    and one launch on the scanner's counters, and its scores equal the
    plain row table scan's on the card bit for bit."""
    tokens, lengths = proteome_database()
    bucketed = scanner.stage_bucketed(tokens, lengths)
    table = bucketed.table
    for stem in ("100", "1400", "2405"):
        prof = profile(stem)
        for mode, pack in (("exact", scanner._device_profile),
                           ("filter", scanner._device_profile_filter)):
            emit, consts = pack(prof)
            before = (scanner.bucketed_scans, scanner.bucketed_launches)
            zero_launches()
            got = torch.from_numpy(scanner.scan_bucketed(prof, bucketed, mode=mode))
            torch.cuda.synchronize()
            counted = nonzero(launches())
            require(counted == {"msv_table_scan": 1},
                    f"{stem}.hmm bucketed {mode} scan launched {counted}, not the row table once")
            require((scanner.bucketed_scans - before[0], scanner.bucketed_launches - before[1])
                    == (1, 1), f"{stem}.hmm bucketed {mode} scan: counters {before} -> "
                    f"{(scanner.bucketed_scans, scanner.bucketed_launches)}")
            want = msv_cuda.msv_table_scan_plain(emit, table, consts)
            err = require_equal([got], [want], f"{stem}.hmm row table {mode} kernel vs plain")
            print(f"bucketed MSV {mode} {stem}.hmm: {lengths.size} rows (longest "
                  f"{int(lengths.max())}) in {len(bucketed.buckets)} buckets, launches {counted}, "
                  f"== the plain row table scan (max|d|={err})", flush=True)


def msv_plans_vs_default(scanner, staged, errors: dict) -> None:
    """Every compiled block size W equals the default plan (scores and
    carries) in both modes on 1400.hmm and 2405.hmm; STRIDE_COPIES stacked
    copies, whose few blocks a profile walk the batch, equal the single
    scan row for row at every W."""
    for stem in ("1400", "2405"):
        prof = profile(stem)
        for filter_mode in (False, True):
            args = msv_args(scanner, prof, staged, filter_mode=filter_mode)
            cuda_fn, _, what = MSV_FNS[filter_mode]
            name = "msv_filter_scan" if filter_mode else "msv_scan"
            want = cuda_fn(*args)
            for warps in msv_cuda.WARP_CHOICES:
                got = cuda_fn(*args, warps=warps)
                errors[name] = max(errors[name], require_equal(
                    got, want, f"{what} {stem}.hmm at W={warps}"))
            emit, consts = args[0], args[4]
            stack = (emit.expand(STRIDE_COPIES, *emit.shape).contiguous(),
                     consts.expand(STRIDE_COPIES, 3).contiguous())
            for warps in msv_cuda.WARP_CHOICES:
                rows = msv_cuda.msv_stacked_scan_cuda(stack[0], *args[1:4], stack[1], warps=warps)
                err = require_equal(list(rows), [want[0]] * STRIDE_COPIES,
                                    f"{STRIDE_COPIES} stacked {what} copies of {stem}.hmm at "
                                    f"W={warps}")
                errors["msv_stacked_scan"] = max(errors["msv_stacked_scan"], err)
            plan = msv_cuda.device_plan(emit.shape[-1], emit.element_size(),
                                        staged.tokens.shape[0], STRIDE_COPIES, emit.device)
            print(f"MSV plans {stem}.hmm {'filter' if filter_mode else 'exact'}: W in "
                  f"{msv_cuda.WARP_CHOICES} == the default plan; {STRIDE_COPIES} stacked copies "
                  f"on {plan.grid} blocks a profile == the single scan at every W")


# -- Viterbi / Forward (phases 6, 7) -------------------------------------------

def p7_calls(kind: str, pack, staged):
    """``(run(tokens, lengths, carry), fresh carry)`` of one p7 scan."""
    if kind == "forward":
        carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)

        def run(fn, tokens, lengths, c):
            return fn(*pack[:4], tokens, lengths, staged.tr_rows, staged.tr_probs,
                      pack.consts, *c)
    elif kind == "filter":
        carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

        def run(fn, tokens, lengths, c):
            return fn(*pack[:4], tokens, lengths, staged.tr_rows, pack.consts, *c,
                      pack.window, pack.e_skip_d)
    elif kind == "save":
        carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)

        def run(fn, tokens, lengths, c):
            return fn(*pack[:4], tokens, lengths, staged.tr_rows, staged.tr_probs,
                      pack.consts, *c)
    else:
        carry = p7_cuda.viterbi_init_carry(staged.tr_rows, pack.m_pad)

        def run(fn, tokens, lengths, c):
            args = (*pack[:4], tokens, lengths, staged.tr_rows, pack.consts, *c)
            return fn(*args, pack.lazy_k) if kind == "lazy" else fn(*args)
    return run, carry


CUDA_FNS = {"eager": p7_cuda.viterbi_scan_cuda, "lazy": p7_cuda.viterbi_lazy_scan_cuda,
            "forward": p7_cuda.forward_prob_scan_cuda,
            "filter": p7_cuda.viterbi_filter_scan_cuda,
            "log": p7_cuda.forward_log_scan_cuda,
            "save": posterior_cuda.forward_save_scan_cuda}
PLAIN_FNS = {"eager": p7_cuda.viterbi_scan_plain, "lazy": p7_cuda.viterbi_lazy_scan_plain,
             "forward": p7_cuda.forward_prob_scan_plain,
             "filter": p7_cuda.viterbi_filter_scan_plain,
             "log": p7_cuda.forward_log_scan_plain,
             "save": posterior_cuda.forward_save_scan_plain}


def p7_chain_error(kind: str, pack, staged) -> float:
    """Two kernel calls split at P7_SPLIT against one call (bit for bit)."""
    run, carry = p7_calls(kind, pack, staged)
    fn = CUDA_FNS[kind]
    whole = run(fn, staged.tokens, staged.lengths, carry)
    first = run(fn, staged.tokens[:, :P7_SPLIT].contiguous(),
                staged.lengths.clamp(max=P7_SPLIT), carry)
    second = run(fn, staged.tokens[:, P7_SPLIT:].contiguous(),
                 (staged.lengths - P7_SPLIT).clamp(min=0), first[1:5])
    torch.cuda.synchronize()
    return require_equal(second[:5], whole[:5], f"{kind} carry chain vs one call")


def pre_diag(pack, m, i, d):
    tmm, _, _, tim, _, tdm = pack.trans[:6]
    return torch.maximum(torch.maximum(m + tmm, i + tim), d + tdm)


def filter_vs_plain(p7, staged, eager_scores, window=None) -> tuple[float, int]:
    """The Viterbi filter kernel at ``window`` (None: auto) against its
    plain version (scores and carries, bit for bit) and >= eager Viterbi;
    returns (max |d|, the window run)."""
    pack = p7_cuda.filter_pack(p7, staged.tokens.device, window_log2=window)
    run, carry = p7_calls("filter", pack, staged)
    got = run(p7_cuda.viterbi_filter_scan_cuda, staged.tokens, staged.lengths, carry)
    torch.cuda.synchronize()
    want = run(p7_cuda.viterbi_filter_scan_plain, staged.tokens, staged.lengths, carry)
    err = require_equal(got, want, f"Viterbi filter kernel (window {pack.window}) vs plain")
    require_geq(got[0], eager_scores, f"Viterbi filter (window {pack.window}) vs eager")
    return err, pack.window


def without_e_skip_d(p7: P7Profile, field: str) -> P7Profile:
    """``p7`` with every finite ``field`` (tdd or tmd) set to 0.01, which
    breaks e_skip_d_ok: E must take D."""
    vec = getattr(p7, field)
    bad = type(p7)(**{**p7.__dict__, field: np.where(
        np.isfinite(vec), np.float32(0.01), vec).astype(np.float32)})
    require(not p7_cuda.e_skip_d_ok(bad), f"{field} = 0.01 kept e_skip_d_ok")
    return bad


def p7_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    lengths = rng.integers(0, RAGGED_LEN + 1, size=P7_BATCH).astype(np.int32)
    lengths[:10] = [0, 1, 31, 32, 33, 257, 128, 129, 600, 599]
    tokens = rng.integers(0, 20, size=(P7_BATCH, RAGGED_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    eager_scores = {}
    groups_seen = {1}
    for stem in stems():
        p7 = p7_profile(stem)
        eager_pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        lazy_pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=True)
        fwd_pack = p7_cuda.forward_pack(p7, scanner.device)
        run_e, carry_v = p7_calls("eager", eager_pack, staged)
        run_l, _ = p7_calls("lazy", lazy_pack, staged)
        run_f, carry_f = p7_calls("forward", fwd_pack, staged)
        eager = run_e(p7_cuda.viterbi_scan_cuda, staged.tokens, staged.lengths, carry_v)
        lazy = run_l(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_v)
        fwd = run_f(p7_cuda.forward_prob_scan_cuda, staged.tokens, staged.lengths, carry_f)
        torch.cuda.synchronize()
        plain = run_e(p7_cuda.viterbi_scan_plain, staged.tokens, staged.lengths, carry_v)
        e_err = require_equal(eager, plain, f"{stem}.hmm eager Viterbi kernel vs plain")
        l_err = require_equal(
            (lazy[0], lazy[1], lazy[2], lazy[3], lazy[4]),
            (eager[0], eager[1], eager[2], pre_diag(eager_pack, *eager[1:4]), eager[4]),
            f"{stem}.hmm lazy Viterbi kernel vs eager kernel",
        )
        fwd_plain = run_f(p7_cuda.forward_prob_scan_plain, staged.tokens, staged.lengths, carry_f)
        f_err = max_abs_diff(fwd[0], fwd_plain[0])
        require(f_err <= FWD_TOL, f"{stem}.hmm Forward kernel vs plain: max |d| {f_err}")
        # the same launches at the most groups a block that fit, against G = 1
        filt_pack = p7_cuda.filter_pack(p7, scanner.device)
        run_vf, _ = p7_calls("filter", filt_pack, staged)
        filt = run_vf(p7_cuda.viterbi_filter_scan_cuda, staged.tokens, staged.lengths, carry_v)
        forced = []
        for kind, run, pack, got in (("eager", run_e, eager_pack, eager),
                                     ("lazy", run_l, lazy_pack, lazy),
                                     ("forward", run_f, fwd_pack, fwd),
                                     ("filter", run_vf, filt_pack, filt)):
            plan = p7_cuda.device_plan(kind, pack.m_pad, passes_of(kind, pack), P7_BATCH, DEVICE)
            require(plan.groups == 1, f"{kind} plan for {P7_BATCH} rows picked G={plan.groups}")
            grouped = run(with_groups(CUDA_FNS[kind], plan.max_groups), staged.tokens,
                          staged.lengths, carry_f if kind == "forward" else carry_v)
            torch.cuda.synchronize()
            require_equal(grouped, got, f"{stem}.hmm {kind} kernel at G={plan.max_groups} vs G=1")
            forced.append(plan.max_groups)
        groups_seen.update(forced)
        vf_err, window = filter_vs_plain(p7, staged, eager[0])
        chains = [p7_chain_error(k, pk, staged)
                  for k, pk in (("eager", eager_pack), ("lazy", lazy_pack), ("forward", fwd_pack),
                                ("filter", filt_pack))]
        eager_scores[stem] = eager[0]
        errors["viterbi_scan"] = max(errors["viterbi_scan"], e_err, chains[0])
        errors["viterbi_lazy_scan"] = max(errors["viterbi_lazy_scan"], l_err, chains[1])
        errors["forward_prob_scan"] = max(errors["forward_prob_scan"], f_err, chains[2])
        errors["viterbi_filter_scan"] = max(errors["viterbi_filter_scan"], vf_err, chains[3])
        print(f"p7 kernels vs plain {stem}.hmm: B={P7_BATCH} L<={RAGGED_LEN} eager max|d|={e_err} "
              f"lazy(k={lazy_pack.lazy_k}) vs eager max|d|={l_err} replays={int(lazy[5].sum())} "
              f"forward(W={fwd_pack.chain.shape[0]}) max|d|={f_err:.3g} filter(window={window}) "
              f"max|d|={vf_err}, >= eager; chains at {P7_SPLIT} max|d|={max(chains)}; eager/lazy/"
              f"forward/filter at G={forced} == G=1", flush=True)

    require(max(groups_seen) > 1, "no profile ran the p7 kernels at G > 1")
    print(f"p7 kernels at G = 1 and at G in {sorted(groups_seen - {1})}: equal on every profile")

    # the Viterbi filter at every window, and without e_skip_d
    for stem in ("100", "1400"):
        p7 = p7_profile(stem)
        full = p7_cuda.chain_passes(p7_cuda.default_m_pad(p7))
        errs = [filter_vs_plain(p7, staged, eager_scores[stem], w)[0] for w in range(1, full + 1)]
        errors["viterbi_filter_scan"] = max(errors["viterbi_filter_scan"], *errs)
        print(f"Viterbi filter {stem}.hmm windows 1..{full}: == plain (max|d|={max(errs)}), "
              f">= eager on all")
    for field in ("tdd", "tmd"):
        bad = without_e_skip_d(p7_profile("100"), field)
        eager_pack = p7_cuda.viterbi_pack(bad, scanner.device, lazy=False)
        run_e, carry_v = p7_calls("eager", eager_pack, staged)
        eager = run_e(p7_cuda.viterbi_scan_cuda, staged.tokens, staged.lengths, carry_v)
        err, window = filter_vs_plain(bad, staged, eager[0])
        errors["viterbi_filter_scan"] = max(errors["viterbi_filter_scan"], err)
        print(f"Viterbi filter 100.hmm without e_skip_d ({field} = 0.01, window {window}): "
              f"== plain (max|d|={err}), >= eager")

    # lazy_k = 1 on 100.hmm: the certificate fires, the replay is counted
    k1 = p7_cuda.viterbi_pack(p7_profile("100"), scanner.device, lazy=True, lazy_k=1)
    run_k1, carry_k1 = p7_calls("lazy", k1, staged)
    got = run_k1(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_k1)
    torch.cuda.synchronize()
    want = run_k1(p7_cuda.viterbi_lazy_scan_plain, staged.tokens, staged.lengths, carry_k1)
    err = require_equal(got, want, "100.hmm lazy_k=1 kernel vs plain (replays included)")
    replays = int(got[5].sum())
    require(replays > 0, "lazy_k=1 on 100.hmm replayed no chunk")
    errors["viterbi_lazy_scan"] = max(errors["viterbi_lazy_scan"], err)
    print(f"lazy_k=1 on 100.hmm: {replays} chunks replayed, equal to plain (max|d|={err})")


def p7_kernels_vs_oracle(scanner, rng, errors: dict) -> None:
    lengths = np.array([0, 1, 100, 300], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 300)).astype(np.int32)
    for stem in ("100", "1400"):
        p7 = p7_profile(stem)
        staged = scanner.stage(tokens, lengths)
        vit = scanner.scan_p7(p7, staged, "viterbi").cpu().numpy()
        eager = viterbi_scores(p7, tokens, lengths, device=scanner.device, lazy=False).cpu().numpy()
        filt = scanner.scan_p7_filter(p7, staged)
        fwd = scanner.scan_p7(p7, staged, "forward").cpu().numpy()
        want_v = viterbi_oracle_batch(p7, tokens, lengths)
        want_f = forward_oracle_batch(p7, tokens, lengths)
        v_err = max(max_abs_diff(torch.from_numpy(x), torch.from_numpy(want_v)) for x in (vit, eager))
        f_err = max_abs_diff(torch.from_numpy(fwd), torch.from_numpy(want_f))
        require(v_err <= VIT_TOL, f"{stem}.hmm Viterbi kernels vs oracle: max |d| {v_err}")
        require(f_err <= FWD_TOL, f"{stem}.hmm Forward kernel vs oracle: max |d| {f_err}")
        require_geq(filt, torch.from_numpy(want_v), f"{stem}.hmm Viterbi filter vs oracle")
        print(f"p7 kernels vs oracle {stem}.hmm: lengths {lengths.tolist()} Viterbi (lazy, eager) "
              f"max|d|={v_err} (tol {VIT_TOL}), Forward max|d|={f_err:.3g} (tol {FWD_TOL})")


# -- log-space Forward and posterior kernels (phases 3, 7) -------------------------

KERNEL_DECODE = (posterior_cuda.forward_save_scan_cuda, posterior_cuda.backward_coverage_scan_cuda)
PLAIN_DECODE = (posterior_cuda.forward_save_scan_plain,
                posterior_cuda.backward_coverage_scan_plain)


def posterior_decode(fwd_fn, bwd_fn, pack, schain, staged):
    """(coverage, totals) of one posterior decode: the row-saving Forward,
    then the backward coverage pass (the kernels or the plain versions)."""
    carry = p7_cuda.forward_init_carry(staged.tr_probs, pack.m_pad)
    total, *_, fm, ls = fwd_fn(*pack[:4], staged.tokens, staged.lengths, staged.tr_rows,
                                staged.tr_probs, pack.consts, *carry)
    cov = bwd_fn(pack.emit_m, pack.emit_i, pack.trans, schain, staged.tokens, staged.lengths,
                 staged.tr_probs, pack.consts, total, fm, ls)
    return cov, total


def backward_inputs(fpack, schain, staged) -> tuple:
    """The backward pass's arguments on the row-saving Forward kernel's own
    rows of ``staged``."""
    carry = p7_cuda.forward_init_carry(staged.tr_probs, fpack.m_pad)
    total, *_, fm, ls = posterior_cuda.forward_save_scan_cuda(
        *fpack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
        fpack.consts, *carry)
    return (fpack.emit_m, fpack.emit_i, fpack.trans, schain, staged.tokens, staged.lengths,
            staged.tr_probs, fpack.consts, total, fm, ls)


def new_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    """For all 24 profiles: the log-space Forward kernel against its plain
    version (LOG_FWD_TOL) on the ragged batch of phase 6, and its two-call
    carry chain against one call (bit for bit); the row-saving Forward
    kernel's scores and carries against the Forward kernel's (bit for bit);
    the posterior kernels' coverage and totals against the plain decode on
    the card (COV_TOL, TOT_TOL) on a ragged batch of POST_BATCH sequences,
    coverage 0 past each length; the backward kernel on the row-saving
    kernel's own rows against its plain version (COV_TOL), and at the most
    groups a block that fit against G = 1 (bit for bit)."""
    lengths = rng.integers(0, RAGGED_LEN + 1, size=P7_BATCH).astype(np.int32)
    lengths[:10] = [0, 1, 31, 32, 33, 257, 128, 129, 600, 599]
    tokens = rng.integers(0, 20, size=(P7_BATCH, RAGGED_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    post_lengths = rng.integers(0, POST_LEN + 1, size=POST_BATCH).astype(np.int32)
    post_lengths[:6] = [0, 1, 7, 8, 9, POST_LEN]
    post = scanner.stage(rng.integers(0, 20, size=(POST_BATCH, POST_LEN)).astype(np.int8),
                         post_lengths)
    past = torch.arange(POST_LEN, device=post.tokens.device)[None, :] >= post.lengths[:, None]
    for stem in stems():
        p7 = p7_profile(stem)
        vpack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        run_l, carry_l = p7_calls("log", vpack, staged)
        got = run_l(p7_cuda.forward_log_scan_cuda, staged.tokens, staged.lengths, carry_l)
        torch.cuda.synchronize()
        want = run_l(p7_cuda.forward_log_scan_plain, staged.tokens, staged.lengths, carry_l)
        l_err = max_abs_diff(got[0], want[0])
        require(l_err <= LOG_FWD_TOL, f"{stem}.hmm log-space Forward kernel vs plain: {l_err}")
        l_chain = p7_chain_error("log", vpack, staged)
        log_g = p7_cuda.device_plan("log", vpack.m_pad, passes_of("log", vpack), P7_BATCH,
                                    DEVICE).max_groups
        grouped = run_l(with_groups(p7_cuda.forward_log_scan_cuda, log_g), staged.tokens,
                        staged.lengths, carry_l)
        torch.cuda.synchronize()
        require_equal(grouped, got, f"{stem}.hmm log-space Forward kernel at G={log_g} vs G=1")

        fpack = p7_cuda.forward_pack(p7, scanner.device)
        run_f, carry_f = p7_calls("forward", fpack, staged)
        plain_fwd = run_f(p7_cuda.forward_prob_scan_cuda, staged.tokens, staged.lengths, carry_f)
        saved = run_f(posterior_cuda.forward_save_scan_cuda, staged.tokens, staged.lengths,
                      carry_f)
        torch.cuda.synchronize()
        s_err = require_equal(saved[:5], plain_fwd,
                              f"{stem}.hmm row-saving Forward kernel vs Forward kernel")
        save_g = p7_cuda.device_plan("save", fpack.m_pad, passes_of("save", fpack), P7_BATCH,
                                     DEVICE).max_groups
        grouped = run_f(with_groups(posterior_cuda.forward_save_scan_cuda, save_g),
                        staged.tokens, staged.lengths, carry_f)
        torch.cuda.synchronize()
        require_equal(grouped, saved, f"{stem}.hmm row-saving Forward at G={save_g} vs G=1")

        schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
        cov, tot = posterior_decode(*KERNEL_DECODE, fpack, schain, post)
        torch.cuda.synchronize()
        cov_p, tot_p = posterior_decode(*PLAIN_DECODE, fpack, schain, post)
        c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(tot, tot_p)
        require(c_err <= COV_TOL and t_err <= TOT_TOL,
                f"{stem}.hmm posterior kernels vs plain: coverage {c_err}, totals {t_err}")
        require(not bool(cov[past].any()), f"{stem}.hmm posterior kernels: coverage past a length")
        # the backward pass (B10's blocked case) on the kernel's own saved
        # rows: its plain version within COV_TOL, and at the most groups a
        # block that fit equal to itself at G = 1 (the plan's pick here)
        bwd_in = backward_inputs(fpack, schain, post)
        bwd_plan = p7_cuda.device_plan("backward", fpack.m_pad, passes_of("backward", fpack),
                                       POST_BATCH, DEVICE)
        require(bwd_plan.groups == 1, f"backward plan for {POST_BATCH} rows: G={bwd_plan.groups}")
        bwd = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
        bwd_g = posterior_cuda.backward_coverage_scan_cuda(*bwd_in, groups=bwd_plan.max_groups)
        torch.cuda.synchronize()
        require_equal([bwd_g], [bwd], f"{stem}.hmm backward kernel at G={bwd_plan.max_groups} "
                      "vs G=1")
        b_err = max_abs_diff(bwd, posterior_cuda.backward_coverage_scan_plain(*bwd_in))
        require(b_err <= COV_TOL, f"{stem}.hmm backward kernel vs plain on its rows: {b_err}")
        errors["forward_log_scan"] = max(errors["forward_log_scan"], l_err, l_chain)
        errors["forward_save_scan"] = max(errors["forward_save_scan"], s_err, t_err)
        errors["backward_coverage_scan"] = max(errors["backward_coverage_scan"], c_err, b_err)
        print(f"log Forward / posterior kernels vs plain {stem}.hmm: log Forward B={P7_BATCH} "
              f"L<={RAGGED_LEN} max|d|={l_err:.3g} chain at {P7_SPLIT} max|d|={l_chain}; "
              f"row-saving Forward == Forward kernel (max|d|={s_err}); log-space Forward at "
              f"G={log_g} and row-saving Forward at G={save_g} == G=1; posterior B={POST_BATCH} "
              f"L<={POST_LEN} coverage max|d|={c_err:.3g} totals max|d|={t_err:.3g}, "
              f"max coverage {float(cov.max()):.4f}; backward kernel on its rows "
              f"max|d|={b_err:.3g}, at G={bwd_plan.max_groups} == G=1", flush=True)


def new_kernels_vs_oracle(scanner, rng, errors: dict) -> None:
    """The log-space Forward entry against the oracle (FWD_TOL) and the
    posterior decode against reference.posterior_match (COV_TOL, TOT_TOL)
    on short sequences of 100.hmm and 1400.hmm."""
    lengths = np.array([0, 1, 100, 300], dtype=np.int32)
    tokens = rng.integers(0, 20, size=(4, 300)).astype(np.int32)
    post_lengths = np.array([1, 40, 96], dtype=np.int32)
    post_tokens = rng.integers(0, 20, size=(3, 96)).astype(np.int32)
    for stem in ("100", "1400"):
        p7 = p7_profile(stem)
        log = forward_scores(p7, tokens, lengths, device=scanner.device, prob_space=False)
        f_err = max_abs_diff(log, torch.from_numpy(forward_oracle_batch(p7, tokens, lengths)))
        require(f_err <= FWD_TOL, f"{stem}.hmm log-space Forward kernel vs oracle: {f_err}")
        cov, tot = posterior_cuda.posterior_coverage_batch(p7, post_tokens, post_lengths,
                                                           device=scanner.device)
        c_err = t_err = 0.0
        for b, n in enumerate(post_lengths):
            want, total = posterior_match(p7, post_tokens[b, :n])
            c_err = max(c_err, float(np.abs(cov[b, :n] - want.sum(axis=1)).max()))
            t_err = max(t_err, abs(float(tot[b]) - float(total)))
        require(c_err <= COV_TOL and t_err <= TOT_TOL,
                f"{stem}.hmm posterior kernels vs posterior_match: {c_err}, {t_err}")
        errors["forward_log_scan"] = max(errors["forward_log_scan"], f_err)
        errors["backward_coverage_scan"] = max(errors["backward_coverage_scan"], c_err)
        errors["forward_save_scan"] = max(errors["forward_save_scan"], t_err)
        print(f"log Forward / posterior kernels vs oracle {stem}.hmm: log Forward lengths "
              f"{lengths.tolist()} max|d|={f_err:.3g} (tol {FWD_TOL}); coverage vs "
              f"posterior_match lengths {post_lengths.tolist()} max|d|={c_err:.3g} "
              f"(tol {COV_TOL}), totals max|d|={t_err:.3g} (tol {TOT_TOL})")


def domains_path(tmp: pathlib.Path, fasta: pathlib.Path, tokens, lengths, planted,
                 scanner) -> dict:
    """`scan --stage search --domains` through the CLI, launch counts zeroed
    around it: every planted row a hit with ndom >= 1 and its envelope
    inside the sequence; the reported envelopes equal those of the kernels'
    coverage; the kernels' coverage >= 0.5 equals the plain decode's on the
    card wherever the plain coverage is more than COV_TOL from 0.5, and so
    do the envelopes of the hits without such positions."""
    hmm = str(PROFILES / "1400.hmm")
    out = tmp / "domains.tsv"
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--domains", "--hmm", hmm,
                                       "--fasta", str(fasta), "--device", DEVICE, "--out",
                                       str(out)])
    for name in ("forward_prob_scan", "forward_save_scan", "backward_coverage_scan"):
        require(got[name] > 0, f"scan --domains did not launch {name}")
    lines = out.read_text().splitlines()
    header = lines[0].lstrip("# ").split("\t")
    require(header[-4:] == ["env_from", "env_to", "ndom", "dom_scores"],
            f"scan --domains header {header}")
    hits = [dict(zip(header, line.split("\t"))) for line in lines[1:]]
    hits = {int(r["target"][3:]): r for r in hits if r["hit"] == "1"}
    for row in planted.tolist():
        r = hits.get(row)
        require(r is not None and int(r["ndom"]) >= 1, f"planted row {row}: no domain")
        require(1 <= int(r["env_from"]) <= int(r["env_to"]) <= int(lengths[row]),
                f"planted row {row}: envelope {r['env_from']}-{r['env_to']} outside "
                f"1-{lengths[row]}")

    idx = np.array(sorted(hits))
    staged = scanner.stage(tokens[idx, : int(lengths[idx].max())], lengths[idx])
    p7 = P7Profile.from_profile(load_profile(hmm))  # as the CLI loads it
    fpack = p7_cuda.forward_pack(p7, scanner.device)
    schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
    cov_k = posterior_decode(*KERNEL_DECODE, fpack, schain, staged)[0].cpu().numpy()
    cov_p = posterior_decode(*PLAIN_DECODE, fpack, schain, staged)[0].cpu().numpy()
    near = 0
    for k, row in enumerate(idx):
        n = int(lengths[row])
        env = cli._envelope_from_coverage(cov_k[k], n) or (0, 0, 0)
        r = hits[int(row)]
        require(env == (int(r["env_from"]), int(r["env_to"]), int(r["ndom"])),
                f"row {row}: reported envelope {r['env_from']}-{r['env_to']} x{r['ndom']} != "
                f"the kernels' coverage {env}")
        close = np.abs(cov_p[k, :n] - 0.5) <= COV_TOL
        same = (cov_k[k, :n] >= 0.5) == (cov_p[k, :n] >= 0.5)
        require(bool(same[~close].all()), f"row {row}: coverage mask differs from plain")
        if close.any():
            near += 1
        else:
            require(env == (cli._envelope_from_coverage(cov_p[k], n) or (0, 0, 0)),
                    f"row {row}: envelope differs from the plain decode's")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    ndoms = [int(hits[int(r)]["ndom"]) for r in idx]
    print(f"main path search --domains: {summary}; {len(hits)} hits decoded, ndom "
          f"{min(ndoms)}-{max(ndoms)}, every planted row a hit with its envelope inside it; "
          f"envelopes equal the kernels' coverage and the plain decode's on the card "
          f"({near} hits with plain coverage within {COV_TOL} of 0.5 somewhere); "
          f"coverage max|d| kernel vs plain {float(np.abs(cov_k - cov_p).max()):.3g}; "
          f"launches {got}")
    print_seconds("main path search --domains", secs, e2e)
    return got


def long_l_referee(rng) -> dict:
    """validate_hw.py's long-sequence drift check through the entry point:
    forward_scores on one LONG_L-residue sequence of 100.hmm in probability
    space against the log-space referee (LONG_TOL), launch counts zeroed
    around both."""
    p7 = p7_profile("100")
    tokens = rng.integers(0, 20, size=(1, LONG_L)).astype(np.int8)
    lengths = np.array([LONG_L], dtype=np.int32)
    zero_launches()
    t0 = time.perf_counter()
    ref = forward_scores(p7, tokens, lengths, device=DEVICE, prob_space=False).cpu()
    prob = forward_scores(p7, tokens, lengths, device=DEVICE).cpu()
    got = launches()
    require(got["forward_log_scan"] > 0 and got["forward_prob_scan"] > 0,
            "the long-L check did not launch both Forward kernels")
    drift = max_abs_diff(prob, ref)
    require(drift <= LONG_TOL, f"long-L prob-vs-log Forward drift {drift}")
    print(f"main path log-space Forward entry: long-L prob-vs-log Forward drift {drift:.3e} "
          f"(tol {LONG_TOL}) at L = {LONG_L} on 100.hmm (scores {float(prob[0]):.4f} / "
          f"{float(ref[0]):.4f}) in {time.perf_counter() - t0:.3f} s; launches {got}")
    return got


# -- profiles wider than 2432 states (phases 8, 9, 10) ----------------------------

def wide_profiles() -> list:
    return [wide_profile(pair) for pair in WIDE_PAIRS]


def wide_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    """Both wide profiles (the MSV and p7 cluster pairs) through every
    kernel against its plain version on a ragged batch of WIDE_BATCH
    sequences up to WIDE_LEN residues: MSV and the MSV filter bit for bit,
    with a carry chain, the filter >= exact; eager == plain, lazy == eager,
    the Viterbi filter == plain and >= eager, Forward within FWD_TOL with a
    carry chain split at P7_SPLIT (a multiple of FWD_RESCALE_GROUP) == one
    call bit for bit, the row-saving Forward == Forward, the log-space
    Forward within LOG_FWD_TOL, every p7 kernel at the most groups a block
    that fit == G = 1 (every kind plans the pair, which takes 1); the
    backward pass's pair on the row-saving kernel's own rows within COV_TOL
    of its plain version (its launches counted as wide) and the posterior
    decode within COV_TOL / TOT_TOL; the stacked kernel over 100.hmm and
    both == the single scans."""
    staged = ragged_wide_batch(scanner, rng)
    hmms = wide_profiles()
    for hmm in hmms:
        msv = MSVProfile.from_profile(hmm)
        p7 = P7Profile.from_profile(hmm)
        require(msv_cuda.kernel_case(msv_cuda.round_up(msv.num_states, 8))[0] == 64
                and p7_cuda.cluster_blocks(p7_cuda.default_m_pad(p7)) == p7_cuda.CLUSTER,
                f"{hmm.name} is not a wide case")
        args = msv_args(scanner, msv, staged)
        err, exact = msv_compare(args)
        chain = msv_chain_error(args)
        f_args = msv_args(scanner, msv, staged, filter_mode=True)
        f_err, filt = msv_compare(f_args, filter_mode=True)
        require_geq(filt, exact, f"{hmm.name} MSV filter kernel vs MSV kernel")
        errors["msv_scan" + WIDE] = max(errors["msv_scan" + WIDE], err, chain)
        errors["msv_filter_scan" + WIDE] = max(errors["msv_filter_scan" + WIDE], f_err)

        packs = p7_packs(p7, scanner.device)
        got, want, plans = {}, {}, {}
        for kind in ("eager", "lazy", "forward", "filter", "log", "save"):
            pack = packs[kind]
            run, carry = p7_calls(kind, pack, staged)
            got[kind] = run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
            torch.cuda.synchronize()
            want[kind] = run(PLAIN_FNS[kind], staged.tokens, staged.lengths, carry)
            plan = p7_cuda.device_plan(kind, pack.m_pad, passes_of(kind, pack), WIDE_BATCH,
                                       DEVICE)
            grouped = run(with_groups(CUDA_FNS[kind], plan.max_groups), staged.tokens,
                          staged.lengths, carry)
            torch.cuda.synchronize()
            require_equal(grouped, got[kind], f"{hmm.name} {kind} kernel at G={plan.max_groups} "
                          "vs G=1")
            require(plan.cluster == p7_cuda.CLUSTER, f"{hmm.name} {kind}: plan {plan}, not the "
                    "cluster pair")
            plans[kind] = f"G<={plan.max_groups} n_trans={plan.n_trans} n_chain={plan.n_chain}"
        e_err = require_equal(got["eager"], want["eager"], f"{hmm.name} eager kernel vs plain")
        l_err = require_equal(
            got["lazy"][:5], (*got["eager"][:3], pre_diag(packs["eager"], *got["eager"][1:4]),
                              got["eager"][4]), f"{hmm.name} lazy kernel vs eager kernel")
        vf_err = require_equal(got["filter"], want["filter"], f"{hmm.name} filter kernel vs plain")
        require_geq(got["filter"][0], got["eager"][0], f"{hmm.name} Viterbi filter vs eager")
        f_err = max_abs_diff(got["forward"][0], want["forward"][0])
        g_err = max_abs_diff(got["log"][0], want["log"][0])
        require(f_err <= FWD_TOL and g_err <= LOG_FWD_TOL,
                f"{hmm.name} Forward / log-space Forward vs plain: {f_err}, {g_err}")
        s_err = require_equal(got["save"][:5], got["forward"],
                              f"{hmm.name} row-saving Forward vs Forward kernel")
        f_chain = p7_chain_error("forward", packs["forward"], staged)
        schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
        # the backward pass's pair at G = 1 on the row-saving kernel's rows
        bwd_in = backward_inputs(packs["forward"], schain, staged)
        zero_launches()
        bwd = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
        torch.cuda.synchronize()
        require(launches()["backward_coverage_scan" + WIDE] == 1,
                f"{hmm.name}: the backward pass's pair did not run ({launches()})")
        b_err = max_abs_diff(bwd, posterior_cuda.backward_coverage_scan_plain(*bwd_in))
        plan = p7_cuda.device_plan("backward", packs["forward"].m_pad,
                                   passes_of("backward", packs["forward"]), WIDE_BATCH, DEVICE)
        require(plan.cluster == p7_cuda.CLUSTER and plan.max_groups == 1 and b_err <= COV_TOL,
                f"{hmm.name} backward pass: plan {plan}, vs plain on its rows {b_err}")
        plans["backward"] = f"G<={plan.max_groups} n_trans={plan.n_trans} n_chain={plan.n_chain}"
        cov, tot = posterior_decode(*KERNEL_DECODE, packs["forward"], schain, staged)
        torch.cuda.synchronize()
        cov_p, tot_p = posterior_decode(*PLAIN_DECODE, packs["forward"], schain, staged)
        c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(tot, tot_p)
        require(c_err <= COV_TOL and t_err <= TOT_TOL,
                f"{hmm.name} posterior kernels vs plain: coverage {c_err}, totals {t_err}")
        for name, e in (("viterbi_scan", e_err), ("viterbi_lazy_scan", l_err),
                        ("viterbi_filter_scan", vf_err),
                        ("forward_prob_scan", max(f_err, f_chain)),
                        ("forward_log_scan", g_err), ("forward_save_scan", max(s_err, t_err)),
                        ("backward_coverage_scan", max(b_err, c_err))):
            errors[name + WIDE] = max(errors[name + WIDE], e)
        print(f"wide {hmm.name} (M {msv.num_states}): B={WIDE_BATCH} L<={WIDE_LEN} MSV max|d|={err} "
              f"chain max|d|={chain}, filter max|d|={f_err} (>= exact); eager max|d|={e_err}, "
              f"lazy == eager, filter(window={packs['filter'].window}) max|d|={vf_err} (>= eager), "
              f"Forward {f_err:.3g} chain at {P7_SPLIT} max|d|={f_chain}, log-space "
              f"{g_err:.3g}, row-saving == Forward, backward pair on its rows {b_err:.3g}, "
              f"coverage {c_err:.3g} totals {t_err:.3g}; every kernel at G=max == G=1; plans "
              f"{plans}",
              flush=True)

    profs = [profile("100")] + [MSVProfile.from_profile(h) for h in hmms]
    for mode, single in (("exact", scanner.scan), ("filter", scanner.scan_filter)):
        res = scanner.scan_many(profs, staged, mode=mode)
        for p in profs:
            require(np.array_equal(res[p.name], single(p, staged).cpu().numpy()),
                    f"stacked {mode} scan of {p.name} vs its single-profile kernel")
    print(f"stacked MSV kernel, 100.hmm and the wide profiles, both modes: == the single-profile "
          f"kernels (max|d|=0.0)")


def wide_paths(tmp: pathlib.Path, fasta: pathlib.Path, tokens, lengths, planted_wide) -> dict:
    """The wide cases on the main paths, launch counts zeroed around each:
    `sweep --stage search --fast` over the 24 profiles and the two wide ones
    (written to .hmm files; the MSV filter, MSV, Viterbi filter, lazy
    Viterbi and Forward kernels at their wide cases; every planted homolog
    of the wider profile one of its hits), `sweep` over 100.hmm and the wide
    ones (the stacked kernel), and on the planted rows the entry points
    viterbi_scores(lazy=False) (eager), forward_scores(prob_space=False)
    (log-space) and posterior_coverage_batch (both posterior kernels)."""
    hmm_dir, msv_dir = tmp / "hmms_wide", tmp / "hmms_wide_msv"
    hmm_dir.mkdir()
    msv_dir.mkdir()
    for stem in stems():
        (hmm_dir / f"{stem}.hmm").write_bytes((PROFILES / f"{stem}.hmm").read_bytes())
    (msv_dir / "100.hmm").write_bytes((PROFILES / "100.hmm").read_bytes())
    for k, hmm in enumerate(wide_profiles()):
        for d in (hmm_dir, msv_dir):
            (d / f"wide{k}.hmm").write_text(format_hmm(hmm))
    wide = load_profile(hmm_dir / "wide1.hmm")  # as the CLI loads it
    wide_p7 = P7Profile.from_profile(wide)
    require(p7_cuda.e_skip_d_ok(wide_p7), f"{wide.name} fails e_skip_d: no lazy kernel")
    counts = {}

    out = tmp / "sweep_wide.tsv"
    got, e2e, secs, records = run_cli(["sweep", "--stage", "search", "--fast", "--hmm-dir",
                                       str(hmm_dir), "--fasta", str(fasta), "--device", DEVICE,
                                       "--out", str(out)])
    for name in ("msv_filter_scan", "msv_scan", "viterbi_filter_scan", "viterbi_lazy_scan",
                 "forward_prob_scan"):
        require(got[name + WIDE] > 0, f"the wide sweep did not launch {name}'s wide case")
        counts[name + WIDE] = got[name + WIDE]
    lines = [r.getMessage() for r in records if r.getMessage().startswith("search ")]
    require(len(lines) == 26, f"{len(lines)} survivor lines, expected 26")
    hits = {t for (t, prof) in hit_rows(out, with_profile=True) if prof == wide.name}
    missed = sorted(set(f"seq{r}" for r in planted_wide.tolist()) - hits)
    require(not missed, f"planted homologs of {wide.name} not reported as its hits: {missed}")
    print(f"main path sweep search --fast, 24 profiles and the wide ones: "
          f"{[line for line in lines if '+' in line]}; all {len(planted_wide)} planted homologs "
          f"of {wide.name} among its {len(hits)} hits; launches {got}")
    print_seconds("main path sweep search --fast (26 profiles)", secs, e2e)

    out = tmp / "sweep_wide_msv.tsv"
    got, e2e, secs, _ = run_cli(["sweep", "--hmm-dir", str(msv_dir), "--fasta", str(fasta),
                                 "--device", DEVICE, "--out", str(out)])
    require(got["msv_stacked_scan" + WIDE] > 0, "the sweep did not launch the stacked wide case")
    counts["msv_stacked_scan" + WIDE] = got["msv_stacked_scan" + WIDE]
    rows = [line.split("\t") for line in out.read_text().splitlines() if not line.startswith("#")]
    require(len(rows) == 3 * BATCH and all(np.isfinite(float(r[3])) for r in rows),
            f"the wide sweep reported {len(rows)} rows or a non-finite score")
    print(f"main path sweep, 100.hmm and the wide profiles: {len(rows)} rows; launches {got}")

    rows = np.asarray(planted_wide)
    l_max = int(lengths[rows].max())
    zero_launches()
    vit = viterbi_scores(wide_p7, tokens[rows, :l_max], lengths[rows], device=DEVICE,
                         lazy=False).cpu().numpy()
    log = forward_scores(wide_p7, tokens[rows, :l_max], lengths[rows], device=DEVICE,
                         prob_space=False).cpu().numpy()
    cov, tot = posterior_cuda.posterior_coverage_batch(wide_p7, tokens[rows, :l_max],
                                                       lengths[rows], device=DEVICE)
    got = launches()
    for name in ("viterbi_scan", "forward_log_scan", "forward_save_scan", "backward_coverage_scan"):
        require(got[name + WIDE] > 0, f"the wide entry points did not launch {name}'s wide case")
        counts[name + WIDE] = got[name + WIDE]
    require(np.isfinite(vit).all() and np.isfinite(log).all() and np.isfinite(tot).all(),
            "wide entry points: non-finite scores")
    require(all(cov[k, : lengths[r]].max() >= 0.5 for k, r in enumerate(rows)),
            "wide posterior: a planted homolog without a covered position")
    print(f"main path wide entries on the {len(rows)} planted rows of {wide.name}: Viterbi "
          f"(eager) {np.round(vit, 2).tolist()}, log-space Forward {np.round(log, 2).tolist()}, "
          f"coverage >= 0.5 on {[int((cov[k] >= 0.5).sum()) for k in range(len(rows))]} "
          f"positions; launches {got}")
    return counts


def versus_parent(name: str, ms: float, work: dict) -> str:
    """A wide case's bound and roofline share at the timed shape, and the
    parent's time of the same case and shape (PARENT_WIDE_MS)."""
    b_ms, b_by = bound(*work[name])
    text = f"bound {b_ms:.3f} ms by {b_by}, share {b_ms / ms:.2%}"
    if name in PARENT_WIDE_MS:
        before = PARENT_WIDE_MS[name]
        text += f"; before (parent, {PARENT_CARD}) {before:.3f} ms, {before / ms:.2f}x"
    return text


def wide_timings(scanner, rng, errors: dict, work: dict) -> dict:
    """Each wide case at one shape against the wider profile (M 4770): MSV,
    the MSV filter and the stacked kernel (both wide profiles, one launch a
    case) at WIDE_MSV_BATCH x 3500; the p7 kernels at the survivor shape 64 x
    3500; the posterior kernels at 64 x 1024; best of 3, each plain version
    once, held against the kernel."""
    hmms = wide_profiles()
    msv = MSVProfile.from_profile(hmms[1])
    p7 = P7Profile.from_profile(hmms[1])
    out = {}
    tokens = rng.integers(0, 20, size=(WIDE_MSV_BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(WIDE_MSV_BATCH, SEQ_LEN, dtype=np.int32))
    cells = staged.total_residues * msv.num_states
    for name, fmode in (("msv_scan", False), ("msv_filter_scan", True)):
        args = msv_args(scanner, msv, staged, filter_mode=fmode)
        cuda_fn, plain_fn, what = MSV_FNS[fmode]
        ms = best_ms(lambda: cuda_fn(*args), reps=3)
        plain_ms, want = once_ms(lambda: plain_fn(*args))
        err = require_equal(cuda_fn(*args), want, f"wide {what} kernel vs plain at the timed shape")
        errors[name + WIDE] = max(errors[name + WIDE], err)
        out[name + WIDE] = (ms, plain_ms)
        work[name + WIDE] = (OPS_PER_CELL["msv"](0) * cells, nbytes(*args) + nbytes(*want))
        print(f"{name}{WIDE}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{WIDE_MSV_BATCH} x {SEQ_LEN} x M={msv.num_states}; plan "
              f"{msv_plan_text(args[0], WIDE_MSV_BATCH)}); plain version {plain_ms:.3f} ms "
              f"(once); {versus_parent(name + WIDE, ms, work)}", flush=True)
    both = [MSVProfile.from_profile(h) for h in hmms]
    packs = [scanner._stacked_pack((p,), "exact") for p in both]
    args = (staged.tokens, staged.lengths, staged.tr_rows)
    ms = best_ms(lambda: [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs], reps=3)
    got = [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs]
    plain_ms, want = once_ms(lambda: [msv_cuda.msv_stacked_scan_plain(e, *args, c)
                                      for e, c in packs])
    err = require_equal(got, want, "wide stacked kernel vs plain at the timed shape")
    both_cells = staged.total_residues * sum(p.num_states for p in both)
    errors["msv_stacked_scan" + WIDE] = max(errors["msv_stacked_scan" + WIDE], err)
    out["msv_stacked_scan" + WIDE] = (ms, plain_ms)
    work["msv_stacked_scan" + WIDE] = (OPS_PER_CELL["msv"](0) * both_cells,
                                       nbytes(*args, *(x for pk in packs for x in pk), *got))
    print(f"msv_stacked_scan{WIDE}: {both_cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
          f"{WIDE_MSV_BATCH} x {SEQ_LEN} x M {'+'.join(str(p.num_states) for p in both)}, "
          f"{len(packs)} launches); plain version {plain_ms:.3f} ms (once); "
          f"{versus_parent('msv_stacked_scan' + WIDE, ms, work)}", flush=True)

    few = scanner.stage(tokens[:SURVIVOR_BATCH], np.full(SURVIVOR_BATCH, SEQ_LEN, dtype=np.int32))
    few_cells = few.total_residues * p7.num_states
    packs = {"viterbi_lazy_scan": ("lazy", p7_cuda.viterbi_pack(p7, scanner.device, lazy=True)),
             "viterbi_scan": ("eager", p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)),
             "forward_prob_scan": ("forward", p7_cuda.forward_pack(p7, scanner.device)),
             "viterbi_filter_scan": ("filter", p7_cuda.filter_pack(p7, scanner.device)),
             "forward_log_scan": ("log", p7_cuda.viterbi_pack(p7, scanner.device, lazy=False))}
    for name, (kind, pack) in packs.items():
        run, carry = p7_calls(kind, pack, few)
        ms = best_ms(lambda: run(CUDA_FNS[kind], few.tokens, few.lengths, carry), reps=3)
        got = run(CUDA_FNS[kind], few.tokens, few.lengths, carry)
        plain_ms, want = once_ms(lambda: run(PLAIN_FNS[kind], few.tokens, few.lengths, carry))
        if kind in ("forward", "log"):
            err = max_abs_diff(got[0], want[0])
            require(err <= FWD_TOL, f"wide {kind} kernel vs plain at the timed shape: {err}")
        else:
            err = require_equal(got, want, f"wide {kind} kernel vs plain at the timed shape")
        errors[name + WIDE] = max(errors[name + WIDE], err)
        out[name + WIDE] = (ms, plain_ms)
        inputs = (*pack[:4], pack.consts, few.tokens, few.lengths, few.tr_rows, *carry)
        work[name + WIDE] = (OPS_PER_CELL[kind](passes_of(kind, pack)) * few_cells,
                             nbytes(*inputs, *got))
        print(f"{name}{WIDE}: {few_cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{SURVIVOR_BATCH} x {SEQ_LEN} x M={p7.num_states}; "
              f"{plan_text(kind, pack, SURVIVOR_BATCH)}); plain version {plain_ms:.3f} ms "
              f"(once), kernel vs plain max|d|={err:.3g}; {versus_parent(name + WIDE, ms, work)}",
              flush=True)

    post = scanner.stage(tokens[:SURVIVOR_BATCH, :POST_TIME_LEN],
                         np.full(SURVIVOR_BATCH, POST_TIME_LEN, dtype=np.int32))
    post_cells = post.total_residues * p7.num_states
    fpack = p7_cuda.forward_pack(p7, scanner.device)
    schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
    fwd_in = (*fpack[:4], post.tokens, post.lengths, post.tr_rows, post.tr_probs, fpack.consts,
              *p7_cuda.forward_init_carry(post.tr_probs, fpack.m_pad))
    save_ms = best_ms(lambda: posterior_cuda.forward_save_scan_cuda(*fwd_in), reps=3)
    saved = posterior_cuda.forward_save_scan_cuda(*fwd_in)
    bwd_in = (fpack.emit_m, fpack.emit_i, fpack.trans, schain, post.tokens, post.lengths,
              post.tr_probs, fpack.consts, saved[0], saved[5], saved[6])
    bwd_ms = best_ms(lambda: posterior_cuda.backward_coverage_scan_cuda(*bwd_in), reps=3)
    cov = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
    plain_save_ms, p_saved = once_ms(lambda: posterior_cuda.forward_save_scan_plain(*fwd_in))
    plain_bwd_ms, cov_p = once_ms(lambda: posterior_cuda.backward_coverage_scan_plain(*bwd_in))
    c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(saved[0], p_saved[0])
    require(c_err <= COV_TOL and t_err <= TOT_TOL,
            f"wide posterior kernels vs plain at the timed shape: {c_err}, {t_err}")
    errors["backward_coverage_scan" + WIDE] = max(errors["backward_coverage_scan" + WIDE], c_err)
    errors["forward_save_scan" + WIDE] = max(errors["forward_save_scan" + WIDE], t_err)
    out["forward_save_scan" + WIDE] = (save_ms, plain_save_ms)
    out["backward_coverage_scan" + WIDE] = (bwd_ms, plain_bwd_ms)
    work["forward_save_scan" + WIDE] = (OPS_PER_CELL["forward"](fpack.chain.shape[0]) * post_cells,
                                        nbytes(*fwd_in, *saved))
    work["backward_coverage_scan" + WIDE] = (
        OPS_PER_CELL["backward"](schain.shape[0]) * post_cells, nbytes(*bwd_in, cov))
    print(f"posterior{WIDE}: the row-saving Forward {save_ms:.3f} ms, the backward coverage pass "
          f"{bwd_ms:.3f} ms (each best of 3, {SURVIVOR_BATCH} x {POST_TIME_LEN} x "
          f"M={p7.num_states}; {plan_text('save', fpack, SURVIVOR_BATCH)}; backward "
          f"{plan_text('backward', fpack, SURVIVOR_BATCH)}); plain versions "
          f"{plain_save_ms:.3f} + {plain_bwd_ms:.3f} ms (once); coverage max|d|={c_err:.3g}; "
          f"row-saving {versus_parent('forward_save_scan' + WIDE, save_ms, work)}; backward "
          f"{versus_parent('backward_coverage_scan' + WIDE, bwd_ms, work)}", flush=True)
    return out


# -- profiles past 4864 states: the rows-in-memory cases (phases 8, 9, 10) ---------

def mem_profiles() -> list:
    return [wide_profile(stems) for stems in MEM_JOINS]


def cluster_profiles() -> list:
    """The joins the MSV kernel runs on C-block clusters, C = CLUSTER_SIZES."""
    return [wide_profile(stems) for stems in MEM_JOINS + CLUSTER_JOINS]


def msv_mem_profile():
    """The join of MSV_MEM_JOIN, named apart from the all-24 join (whose
    name, 24 names long, the loaders cut at the same length)."""
    return dataclasses.replace(wide_profile(MSV_MEM_JOIN), name="all-24-joined-twice")


def ragged_wide_batch(scanner, rng):
    lengths = rng.integers(0, WIDE_LEN + 1, size=WIDE_BATCH).astype(np.int32)
    lengths[:4] = [0, 1, 129, WIDE_LEN]
    tokens = rng.integers(0, 20, size=(WIDE_BATCH, WIDE_LEN)).astype(np.int8)
    return scanner.stage(tokens, lengths)


def msv_vs_plain(scanner, msv: MSVProfile, staged, label: str) -> tuple[float, float, float]:
    """MSV and the MSV filter (carries included) == plain bit for bit, an
    exact carry chain == one call, the filter >= exact, and one stacked
    launch of the exact and the filter table == its plain version; returns
    (exact and chain max |d|, filter max |d|, stacked max |d|)."""
    args = msv_args(scanner, msv, staged)
    err, exact = msv_compare(args)
    chain = msv_chain_error(args)
    f_args = msv_args(scanner, msv, staged, filter_mode=True)
    f_err, filt = msv_compare(f_args, filter_mode=True)
    require_geq(filt, exact, f"{label} MSV filter kernel vs MSV kernel")
    s_err = 0.0
    for fmode in (False, True):
        emit, consts = scanner._stacked_pack((msv,), "filter" if fmode else "exact")
        s_args = (emit, staged.tokens, staged.lengths, staged.tr_rows, consts)
        got = msv_cuda.msv_stacked_scan_cuda(*s_args)
        torch.cuda.synchronize()
        s_err = max(s_err, require_equal([got], [msv_cuda.msv_stacked_scan_plain(*s_args)],
                                         f"{label} stacked MSV kernel vs plain"))
    return max(err, chain), f_err, s_err


def cluster_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    """The joins of MEM_JOINS and CLUSTER_JOINS (LENG 6977, 30181, 11165,
    18170 and 19679: the MSV kernel's C-block clusters at C = 3, 13, 5, 8
    and 9) through MSV, the MSV filter and the stacked kernel against their
    plain versions on a ragged batch of WIDE_BATCH sequences up to WIDE_LEN
    residues, bit for bit (msv_vs_plain), each case launched at its C (the
    wrappers' cluster_launches); the stacked kernel over 100.hmm and all
    five (one launch a C) == the single scans. Then the all-24 join twice
    over (LENG 60362, past 38,912) through the MSV kernels' 16-block cluster
    of 8-warp blocks the same way, block_cluster_launches counting it at C
    = 16 alone (its rows-in-memory route: mem_route_past_38912)."""
    staged = ragged_wide_batch(scanner, rng)
    hmms = cluster_profiles()
    for hmm, c in zip(hmms, CLUSTER_SIZES):
        msv = MSVProfile.from_profile(hmm)
        lanes, per = msv_cuda.device_case(msv_cuda.round_up(msv.num_states, 8), 4, scanner.device)
        require(msv_cuda.cluster_blocks(lanes) == c, f"{hmm.name[:40]}: the MSV case is "
                f"{lanes} lanes, not a {c}-block cluster")
        zero_launches()
        errs = msv_vs_plain(scanner, msv, staged, hmm.name[:40])
        got = cluster_launches()
        require(all(set(got[name]) == {c} for name in MSV_WRAPPERS),
                f"{hmm.name[:40]}: cluster launches {got}, expected C = {c} only")
        for name, e in zip(MSV_WRAPPERS, errs):
            errors[name + CLUSTER] = max(errors[name + CLUSTER], e)
        print(f"MSV {c}-block cluster, {hmm.name[:40]} (M {msv.num_states}, {lanes} lanes x "
              f"{per}): B={WIDE_BATCH} L<={WIDE_LEN} exact and chain max|d|={errs[0]}, filter "
              f"max|d|={errs[1]} (>= exact), stacked max|d|={errs[2]}; cluster launches {got}",
              flush=True)
    profs = [profile("100")] + [MSVProfile.from_profile(h) for h in hmms]
    zero_launches()
    for mode, single in (("exact", scanner.scan), ("filter", scanner.scan_filter)):
        res = scanner.scan_many(profs, staged, mode=mode)
        for p in profs:
            require(np.array_equal(res[p.name], single(p, staged).cpu().numpy()),
                    f"stacked {mode} scan of {p.name[:40]} vs its single-profile kernel")
    stacked = cluster_launches()["msv_stacked_scan"]
    require(stacked == {c: 2 for c in sorted(CLUSTER_SIZES)},
            f"stacked cluster launches {stacked}, expected one a C and mode")
    print(f"stacked MSV kernel, 100.hmm and the five joins, both modes: == the single-profile "
          f"kernels; stacked cluster launches by C {stacked}")

    big = MSVProfile.from_profile(msv_mem_profile())
    m_pad = msv_cuda.round_up(big.num_states, 8)
    lanes, per = msv_cuda.device_case(m_pad, 4, scanner.device)
    require(m_pad > msv_cuda.MAX_CLUSTER_STATES and msv_cuda.wide_cluster_case(lanes, per),
            f"M {big.num_states}: the MSV case is {lanes} lanes x {per}, not the 16-block "
            "cluster of 8-warp blocks")
    zero_launches()
    errs = msv_vs_plain(scanner, big, staged, f"M {big.num_states}")
    got, by_c = launches(), cluster_launches()
    require(all(set(by_c[name + CLUSTER256]) == {16} and not by_c[name]
                and got[name + MEM] == 0 for name in MSV_WRAPPERS),
            f"M {big.num_states}: the MSV kernels did not launch their 16-block cluster of "
            f"8-warp blocks alone ({got}, {by_c})")
    for name, e in zip(MSV_WRAPPERS, errs):
        errors[name + CLUSTER256] = max(errors[name + CLUSTER256], e)
    print(f"MSV 16-block cluster of 8-warp blocks, the all-24 join twice (M {big.num_states}, "
          f"{lanes} lanes x {per}, {msv_cuda.wide_staged(per)} staged): B={WIDE_BATCH} "
          f"L<={WIDE_LEN} exact and chain max|d|={errs[0]}, filter max|d|={errs[1]} (>= exact), "
          f"stacked max|d|={errs[2]}; launches by C "
          f"{({n: by_c[n + CLUSTER256] for n in MSV_WRAPPERS})}", flush=True)


def case_suffix(plan) -> str:
    """The JSON row suffix of a p7 case past 4864 states: CLUSTER for a
    C-block cluster, BLOCK for the wide block, BLOCKS for a cluster of wide
    blocks, CLUSTER256 for a C-block cluster of 256-thread blocks, MEM for
    the rows-in-memory case."""
    if plan.block_cluster:
        return BLOCKS
    if plan.wide_cluster:
        return CLUSTER256
    if plan.cluster > p7_cuda.CLUSTER:
        return CLUSTER
    return BLOCK if plan.block else MEM


def expected_case(m_pad: int, kind: str) -> tuple[int, int]:
    """(cluster, threads) of the plan ``kind`` takes past 4864 states: its
    C-block cluster, the wide block, a cluster of wide blocks, a C-block
    cluster of 256-thread blocks or the rows-in-memory case."""
    c = p7_cuda.cluster_blocks(m_pad, kind)
    if p7_cuda.block_cluster_case(m_pad, kind):
        return c, p7_cuda.BLOCK_THREADS
    if p7_cuda.wide_cluster_case(m_pad, kind):
        return c, p7_cuda.WIDE_CLUSTER_THREADS
    if c > 1:
        return c, p7_cuda.KERNEL_THREADS
    if p7_cuda.block_case(m_pad, kind):
        return p7_cuda.BLOCK_CLUSTER, p7_cuda.BLOCK_THREADS
    return 1, p7_cuda.MEM_THREADS


def mem_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    """Both joins of MEM_JOINS (LENG 6977 and 30181: C = 3 and 13) through
    every p7 kernel past 4864 states against its plain version on a ragged
    batch of WIDE_BATCH sequences up to WIDE_LEN residues: the lazy Viterbi,
    the Viterbi filter, Forward, the row-saving Forward and the backward
    pass on their C-block clusters, the eager Viterbi and the log-space
    Forward on the wide block (LENG 6977) and on a cluster of 4 wide blocks
    (30181); then the all-24 join twice over (LENG 60362, past 38,912)
    through the eager, log-space and lazy kinds' cluster of 8 wide blocks
    and Forward's, the row-saving Forward's, the backward pass's and the
    Viterbi filter's cluster of 13 256-thread blocks, and the lazy kind,
    Forward, the posterior pair, the filter and MSV again on their
    rows-in-memory route (a card that holds no such cluster,
    no_block_clusters: mem_route_past_38912). Eager,
    lazy (replay counts included) and the Viterbi filter bit for bit, the
    filter >= the exact scores; the lazy kernel again at lazy_k = 1, whose
    certificate fires below 16 chain passes (the fire count printed, above
    0), bit for bit; past 38,912 the lazy kernel with no replay and a carry
    chain == one call; Forward within FWD_TOL and log-space Forward within
    LOG_FWD_TOL of plain, the row-saving Forward == Forward bit for bit
    where both run one case (every width; if a card ran them on different
    cases, within FWD_TOL of its plain version and of the Forward kernel),
    eager and Forward carry chains == one call;
    the backward pass on the kernel's own rows within COV_TOL of plain and
    the whole decode within COV_TOL / TOT_TOL. Each kind must launch its
    case and no other (the launch counters: cluster_launches and
    block_cluster_launches by C, block_launches, mem_launches)."""
    staged = ragged_wide_batch(scanner, rng)
    kinds = ("eager", "lazy", "forward", "filter", "log", "save")
    joins = [(hmm, kinds) for hmm in mem_profiles() + [msv_mem_profile()]]
    for hmm, kinds in joins:
        p7 = P7Profile.from_profile(hmm)
        m_pad = p7_cuda.default_m_pad(p7)
        packs = p7_packs(p7, scanner.device)
        packs["lazy_k1"] = p7_cuda.viterbi_pack(p7, scanner.device, lazy=True, lazy_k=1)
        zero_launches()
        got, want, cases = {}, {}, {}
        for kind in kinds + (("lazy_k1",) if "lazy" in kinds else ()):
            base = "lazy" if kind == "lazy_k1" else kind
            run, carry = p7_calls(base, packs[kind], staged)
            got[kind] = run(CUDA_FNS[base], staged.tokens, staged.lengths, carry)
            torch.cuda.synchronize()
            want[kind] = run(PLAIN_FNS[base], staged.tokens, staged.lengths, carry)
            plan = p7_cuda.device_plan(base, m_pad, passes_of(base, packs[kind]), WIDE_BATCH,
                                       DEVICE)
            require((plan.cluster, plan.threads) == expected_case(m_pad, base),
                    f"{hmm.name[:40]} {base}: plan {plan}, expected (cluster, threads) "
                    f"{expected_case(m_pad, base)}")
            cases[base] = case_suffix(plan)
        l_err = require_equal(got["lazy"], want["lazy"], f"{hmm.name[:40]} lazy kernel vs plain")
        if p7_cuda.block_cluster_case(m_pad, "lazy"):
            require(int(got["lazy"][5].sum()) == 0, f"{hmm.name[:40]}: the lazy kernel replayed "
                    f"{int(got['lazy'][5].sum())} chunks on the whole chain")
            l_err = max(l_err, p7_chain_error("lazy", packs["lazy"], staged))
        plan = p7_cuda.device_plan("backward", m_pad, passes_of("backward", packs["forward"]),
                                   WIDE_BATCH, DEVICE)
        require((plan.cluster, plan.threads) == expected_case(m_pad, "backward"),
                f"{hmm.name[:40]} backward: plan {plan}")
        cases["backward"] = case_suffix(plan)
        k1_err = require_equal(got["lazy_k1"], want["lazy_k1"],
                               f"{hmm.name[:40]} lazy kernel at lazy_k = 1 vs plain")
        fires = int(got["lazy_k1"][5].sum())
        passes = p7_cuda.chain_passes(m_pad)
        require(fires > 0 or passes > 15, f"{hmm.name[:40]}: lazy_k = 1 never fired")
        vf_err = require_equal(got["filter"], want["filter"], f"{hmm.name[:40]} filter vs plain")
        require_geq(got["filter"][0], got["lazy"][0], f"{hmm.name[:40]} Viterbi filter vs lazy")
        f_err = max_abs_diff(got["forward"][0], want["forward"][0])
        require(f_err <= FWD_TOL, f"{hmm.name[:40]} Forward vs plain: {f_err}")
        if cases["save"] == cases["forward"]:
            s_err = require_equal(got["save"][:5], got["forward"],
                                  f"{hmm.name[:40]} row-saving Forward vs Forward kernel")
        else:
            s_err = max(max_abs_diff(g, w) for g, w in zip(got["save"][:5], want["save"][:5]))
            sf_err = max_abs_diff(got["save"][0], got["forward"][0])
            require(s_err <= FWD_TOL and sf_err <= FWD_TOL,
                    f"{hmm.name[:40]} row-saving Forward ({cases['save']}) vs plain: {s_err}, "
                    f"vs the Forward kernel ({cases['forward']}): {sf_err}")
        f_chain = p7_chain_error("forward", packs["forward"], staged)
        schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
        bwd_in = backward_inputs(packs["forward"], schain, staged)
        cov = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
        torch.cuda.synchronize()
        b_err = max_abs_diff(cov, posterior_cuda.backward_coverage_scan_plain(*bwd_in))
        cov_p, tot_p = posterior_decode(*PLAIN_DECODE, packs["forward"], schain, staged)
        c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(bwd_in[8], tot_p)
        require(b_err <= COV_TOL and c_err <= COV_TOL and t_err <= TOT_TOL,
                f"{hmm.name[:40]} posterior kernels vs plain: on the kernel's rows {b_err}, the "
                f"decode {c_err}, totals {t_err}")
        found = [("viterbi_lazy_scan", "lazy", max(l_err, k1_err)),
                 ("viterbi_filter_scan", "filter", vf_err),
                 ("forward_prob_scan", "forward", max(f_err, f_chain)),
                 ("forward_save_scan", "save", max(s_err, t_err)),
                 ("backward_coverage_scan", "backward", max(b_err, c_err))]
        text = ""
        if "eager" in kinds:
            e_err = require_equal(got["eager"], want["eager"], f"{hmm.name[:40]} eager vs plain")
            require_equal([got["lazy"][0]], [got["eager"][0]], f"{hmm.name[:40]} lazy vs eager")
            e_chain = p7_chain_error("eager", packs["eager"], staged)
            g_err = max_abs_diff(got["log"][0], want["log"][0])
            require(g_err <= LOG_FWD_TOL, f"{hmm.name[:40]} log-space Forward vs plain: {g_err}")
            found += [("viterbi_scan", "eager", max(e_err, e_chain)), ("forward_log_scan", "log", g_err)]
            text = (f"eager{cases['eager']} max|d|={e_err} chain {e_chain} (== lazy), "
                    f"log-space{cases['log']} {g_err:.3g}, ")
        for name, kind, e in found:
            key = name + cases[kind]
            errors[key] = max(errors[key], e)
        got_l = launches()
        by_c = cluster_launches()
        for name, kind, _ in found:
            c = p7_cuda.cluster_blocks(m_pad, kind)
            if p7_cuda.block_cluster_case(m_pad, kind):
                require(set(by_c[name + BLOCKS]) == {c} and got_l[name + MEM] == 0
                        and got_l.get(name + BLOCK, 0) == 0,
                        f"{hmm.name[:40]} {name}: launches {got_l}, by C {by_c[name + BLOCKS]}; "
                        f"expected the cluster of {c} wide blocks only")
            elif p7_cuda.wide_cluster_case(m_pad, kind):
                require(set(by_c[name + CLUSTER256]) == {c} and got_l[name + MEM] == 0
                        and not by_c[name],
                        f"{hmm.name[:40]} {name}: launches {got_l}, by C "
                        f"{by_c[name + CLUSTER256]}; expected the cluster of {c} 256-thread "
                        f"blocks only")
            elif c > 1:
                require(set(by_c[name]) == {c} and got_l[name + MEM] == 0,
                        f"{hmm.name[:40]} {name}: launches {got_l}, by C {by_c[name]}; expected "
                        f"the {c}-block cluster only")
            elif p7_cuda.block_case(m_pad, kind):
                require(got_l[name + BLOCK] > 0 and got_l[name + MEM] == 0,
                        f"{hmm.name[:40]} {name}: not the wide block ({got_l})")
            else:
                require(got_l[name + MEM] > 0 and not by_c.get(name)
                        and got_l.get(name + BLOCK, 0) == 0 and got_l.get(name + BLOCKS, 0) == 0,
                        f"{hmm.name[:40]} {name}: not the rows-in-memory case ({got_l})")
        print(f"past 4864 states {hmm.name[:40]} (M {p7.num_states}, {passes} chain passes, "
              f"cases {cases}): B={WIDE_BATCH} L<={WIDE_LEN} {text}lazy(k="
              f"{packs['lazy'].lazy_k}) max|d|={l_err} replays {int(got['lazy'][5].sum())}, "
              f"lazy(k=1) max|d|={k1_err} fires {fires}, filter(window={packs['filter'].window}) "
              f"max|d|={vf_err} (>= lazy), Forward {f_err:.3g} chain {f_chain}, row-saving vs "
              f"Forward {s_err:.3g}; backward on its rows {b_err:.3g}, decode coverage "
              f"{c_err:.3g} totals {t_err:.3g}; launches by C {by_c}", flush=True)
        if p7_cuda.wide_cluster_case(m_pad, "save"):
            mem_route_past_38912(hmm, p7, packs, schain, staged, want, errors)


def mem_route_past_38912(hmm, p7, packs, schain, staged, want, errors: dict) -> None:
    """The lazy Viterbi, Forward, the row-saving Forward, the backward
    pass, the Viterbi filter and MSV (exact, filter, stacked) past 38,912
    states on the rows-in-memory route of a card that holds no cluster of
    wide or 256-thread blocks (no_block_clusters), once each: the lazy
    kernel and the filter == their plain versions' ``want`` bit for bit,
    Forward within FWD_TOL of ``want["forward"]``, the row-saving kernel ==
    the Forward kernel bit for bit (both their rows-in-memory case), the
    backward pass on its rows within COV_TOL of plain, MSV == plain bit for
    bit (msv_vs_plain: a carry chain, the filter >= exact, a stacked launch
    a mode), each wrapper's mem_launches showing the route and no cluster
    launch."""
    fpack = packs["forward"]
    run, carry = p7_calls("save", fpack, staged)
    run_l, carry_l = p7_calls("lazy", packs["lazy"], staged)
    run_f, carry_f = p7_calls("filter", packs["filter"], staged)
    msv = MSVProfile.from_profile(hmm)
    with no_block_clusters():
        zero_launches()
        lazy = run_l(CUDA_FNS["lazy"], staged.tokens, staged.lengths, carry_l)
        forward = run(CUDA_FNS["forward"], staged.tokens, staged.lengths, carry)
        saved = run(CUDA_FNS["save"], staged.tokens, staged.lengths, carry)
        bwd_in = backward_inputs(fpack, schain, staged)
        cov = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
        filt = run_f(CUDA_FNS["filter"], staged.tokens, staged.lengths, carry_f)
        torch.cuda.synchronize()
        m_errs = msv_vs_plain(MSVScanner(device=staged.tokens.device), msv, staged,
                              f"LENG {p7.num_states} on the rows-in-memory route")
        got = launches()
    l_err = require_equal(lazy, want["lazy"], f"LENG {p7.num_states} lazy kernel on the "
                          "rows-in-memory route vs plain")
    vf_err = require_equal(filt, want["filter"], f"LENG {p7.num_states} Viterbi filter on the "
                           "rows-in-memory route vs plain")
    f_err = max_abs_diff(forward[0], want["forward"][0])
    require(f_err <= FWD_TOL, f"LENG {p7.num_states} Forward on the rows-in-memory route vs "
            f"plain: {f_err}")
    s_err = require_equal(saved[:5], forward, f"LENG {p7.num_states} row-saving Forward on the "
                          "rows-in-memory route vs the Forward kernel")
    b_err = max_abs_diff(cov, posterior_cuda.backward_coverage_scan_plain(*bwd_in))
    require(b_err <= COV_TOL, f"LENG {p7.num_states} backward pass on the rows-in-memory route "
            f"vs plain: {b_err}")
    for name in CLUSTER256_WRAPPERS + ("viterbi_lazy_scan",):
        require(got[name + MEM] > 0 and got[name + CLUSTER256 if name in CLUSTER256_WRAPPERS
                                             else name + BLOCKS] == 0,
                f"the rows-in-memory route did not launch {name}'s memory case alone ({got})")
    for name, err in (("viterbi_lazy_scan", l_err), ("forward_prob_scan", f_err),
                      ("forward_save_scan", s_err), ("backward_coverage_scan", b_err),
                      ("viterbi_filter_scan", vf_err), *zip(MSV_WRAPPERS, m_errs)):
        errors[name + MEM] = max(errors[name + MEM], err)
    print(f"the rows-in-memory route (no cluster of wide or 256-thread blocks held), LENG "
          f"{p7.num_states}: lazy == plain, Forward {f_err:.3g}, row-saving Forward == the "
          f"Forward kernel, backward on its rows {b_err:.3g}, the Viterbi filter == plain, "
          f"MSV exact, filter and stacked == plain; launches {nonzero(got)}", flush=True)


def block_cluster_kernels_vs_plain(scanner, rng, errors: dict) -> None:
    """The eager Viterbi and the log-space Forward on their clusters of wide
    blocks at C = 2 and 3 (the joins of CLUSTER_JOINS: LENG 11165, 18170,
    19679) against their plain versions on the ragged batch of
    mem_kernels_vs_plain (eager bit for bit, with a carry chain; log-space
    within LOG_FWD_TOL), each launching its cluster alone, and each timed
    once at SURVIVOR_BATCH x MEM_TIME_LEN after a warm-up (the step's cost
    at C = 2 and 3, printed); then the rows-in-memory route of a card that
    holds no such cluster (no_block_clusters) on the all-24 join (LENG
    30181) against plain, the wrappers' mem_launches showing it."""
    staged = ragged_wide_batch(scanner, rng)
    tokens = rng.integers(0, 20, size=(SURVIVOR_BATCH, MEM_TIME_LEN)).astype(np.int8)
    timed = scanner.stage(tokens, np.full(SURVIVOR_BATCH, MEM_TIME_LEN, dtype=np.int32))
    for stems in CLUSTER_JOINS:
        p7 = P7Profile.from_profile(wide_profile(stems))
        pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
        m_pad = pack.m_pad
        c = p7_cuda.cluster_blocks(m_pad, "eager")
        text = []
        for name, kind in (("viterbi_scan", "eager"), ("forward_log_scan", "log")):
            zero_launches()
            run, carry = p7_calls(kind, pack, staged)
            got = run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
            torch.cuda.synchronize()
            want = run(PLAIN_FNS[kind], staged.tokens, staged.lengths, carry)
            by_c = cluster_launches()[name + BLOCKS]
            require(by_c == {c: 1} and launches()[name + MEM] == 0,
                    f"LENG {p7.num_states} {name}: launches by C {by_c}, expected the cluster "
                    f"of {c} wide blocks")
            if kind == "eager":
                err = max(require_equal(got, want, f"LENG {p7.num_states} eager vs plain"),
                          p7_chain_error("eager", pack, staged))
            else:
                err = max_abs_diff(got[0], want[0])
                require(err <= LOG_FWD_TOL, f"LENG {p7.num_states} log-space vs plain: {err}")
            errors[name + BLOCKS] = max(errors[name + BLOCKS], err)
            run, carry = p7_calls(kind, pack, timed)
            plan = p7_cuda.device_plan(kind, m_pad, p7_cuda.chain_passes(m_pad), SURVIVOR_BATCH,
                                       DEVICE)
            ms = best_ms(lambda: run(CUDA_FNS[kind], timed.tokens, timed.lengths, carry), reps=1)
            rounds = -(-SURVIVOR_BATCH // (plan.grid // plan.cluster))
            text.append(f"{kind} max|d|={err:.3g}, {ms:.3f} ms at {SURVIVOR_BATCH} x "
                        f"{MEM_TIME_LEN} ({ms * 1e3 / (MEM_TIME_LEN * rounds):.2f} us a step, "
                        f"{rounds} rounds)")
        print(f"cluster of wide blocks LENG {p7.num_states} (M_pad {m_pad}, C {c}, per "
              f"{p7_cuda.kernel_case(m_pad, 'eager')[1]}; {plan_text('eager', pack, 64)}): "
              f"{'; '.join(text)}", flush=True)

    p7 = P7Profile.from_profile(mem_profiles()[1])
    pack = p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)
    with no_block_clusters():
        zero_launches()
        for name, kind in (("viterbi_scan", "eager"), ("forward_log_scan", "log")):
            plan = p7_cuda.device_plan(kind, pack.m_pad, p7_cuda.chain_passes(pack.m_pad),
                                       WIDE_BATCH, DEVICE)
            require(plan.mem, f"{kind} with no cluster of wide blocks held: plan {plan}")
            run, carry = p7_calls(kind, pack, staged)
            got = run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
            torch.cuda.synchronize()
            want = run(PLAIN_FNS[kind], staged.tokens, staged.lengths, carry)
            if kind == "eager":
                err = require_equal(got, want, "eager rows-in-memory route vs plain")
            else:
                err = max_abs_diff(got[0], want[0])
                require(err <= LOG_FWD_TOL, f"log-space rows-in-memory route vs plain: {err}")
            errors[name + MEM] = max(errors[name + MEM], err)
        got = launches()
    for name in BLOCK_WRAPPERS:
        require(got[name + MEM] == 1 and got[name + BLOCKS] == 0,
                f"the rows-in-memory route did not launch {name}'s memory case alone ({got})")
    print(f"the rows-in-memory route (no cluster of wide blocks held), LENG {p7.num_states}: "
          f"eager == plain, log-space max|d|={errors['forward_log_scan' + MEM]:.3g}; launches "
          f"{nonzero(got)}", flush=True)


# the short release stress of the C-block clusters (tools/torch_cluster_check.py
# --stress): launches a kind and case, the 128-thread clusters' C, the
# 256-thread clusters' C, the lazy kind's clusters of wide blocks' C and the
# M_pad of MSV's 16-block cluster of 8-warp blocks
STRESS_LAUNCHES, STRESS_C, STRESS_WIDE_C, STRESS_BLOCKS_C = 10, (4, 8, 13, 16), (13,), (8,)
STRESS_MSV = (60368,)


def release_stress() -> None:
    """tools/torch_cluster_check.py --stress STRESS_LAUNCHES in a process of
    its own: the lazy Viterbi replaying the whole chain, the Viterbi filter
    at its longest window, Forward, the row-saving Forward and the backward
    pass on C-block clusters of 128-thread blocks at each C of STRESS_C,
    Forward, the posterior pair and the filter on 256-thread blocks at
    STRESS_WIDE_C, the lazy Viterbi on clusters of wide blocks at
    STRESS_BLOCKS_C, MSV, the MSV filter and the stacked kernel on their
    16-block cluster of 8-warp blocks at STRESS_MSV, every launch equal to
    its case's first; a hang (no launch ending for its STRESS_SILENCE
    seconds) fails, naming the launch under way."""
    cmd = [sys.executable, str(REPO / "tools" / "torch_cluster_check.py"), "--stress",
           str(STRESS_LAUNCHES), "--stress-c", ",".join(map(str, STRESS_C)), "--stress-wide",
           ",".join(map(str, STRESS_WIDE_C)), "--stress-blocks",
           ",".join(map(str, STRESS_BLOCKS_C)), "--stress-msv", ",".join(map(str, STRESS_MSV))]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600)
    result = next((json.loads(line) for line in done.stdout.splitlines()
                   if line.startswith('{"stress"')), None)
    require(done.returncode == 0 and result is not None and result["stress"] == "ok",
            f"release stress (rc {done.returncode}): {done.stdout[-2000:]} "
            f"{done.stderr[-2000:]}")
    print(f"release stress: {result['total_launches']} launches ({STRESS_LAUNCHES} a kind and "
          f"case, C {STRESS_C} at 128 threads, {STRESS_WIDE_C} at 256, {STRESS_BLOCKS_C} wide "
          f"blocks, MSV at M_pad {STRESS_MSV}), none hung, each equal to its case's first, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def mem_paths(tmp: pathlib.Path, rng) -> dict:
    """The cases past 4864 states on the main paths, launch counts zeroed
    around each, on MEM_BATCH random rows of MEM_LEN residues with
    MEM_PLANTED sequences sampled from the three-profile join (LENG 6977) at
    known rows: `scan --stage search --domains` (the 3-block clusters of
    MSV, the lazy Viterbi, Forward, the row-saving Forward and the backward
    pass, none of them in memory; every planted row a hit with its envelope
    inside it), `scan --stage search --fast` (the
    3-block clusters of the MSV filter, the Viterbi filter, the lazy
    Viterbi and Forward, none in memory; the plain search's hit rows),
    `sweep` over both joins and the all-24 join twice over (the stacked
    kernel's 3- and 13-block clusters and its 16-block cluster of 8-warp
    blocks), `scan` (MSV) and MSVScanner.scan_filter with that join (LENG
    60362: the MSV kernels' 16-block cluster of 8-warp blocks), `scan
    --stage search --fast --config` (msv_p 1: every row past MSV) with that
    join on FAST_PAST_ROWS rows (the MSV filter's, MSV's and the Viterbi
    filter's clusters past 38,912), on the
    planted rows the entry points viterbi_scores(lazy=False) (eager) and
    forward_scores(prob_space=False) (log-space) on the wide block, and on
    MEM_PLANTED rows the entry points of the eager and lazy Viterbi, the
    Viterbi filter, Forward, the log-space Forward and the posterior decode
    with the LENG 60362 join (the eager, log-space and lazy kinds' cluster
    of 8 wide blocks, Forward's, the posterior pair's and the filter's
    cluster of 13 256-thread blocks), the lazy, Forward, posterior and
    filter entries and MSVScanner.scan, scan_filter and scan_many there
    again on a card that holds no cluster of wide or 256-thread blocks, nor
    MSV's (== the clusters' scores), and the eager and log-space entries
    with the LENG 30181 join on a card that holds no cluster of wide blocks
    (no_block_clusters: their rows-in-memory cases)."""
    hmm_dir = tmp / "hmms_mem"
    hmm_dir.mkdir()
    joins = mem_profiles() + [msv_mem_profile()]
    for k, hmm in enumerate(joins):
        (hmm_dir / f"mem{k}.hmm").write_text(format_hmm(hmm))
    path = hmm_dir / "mem0.hmm"
    seqs = sample_sequences(joins[0], MEM_PLANTED, seed=SEED)
    width = max(MEM_LEN, max(len(q) for q in seqs))
    tokens = rng.integers(0, 20, size=(MEM_BATCH, width)).astype(np.int8)
    lengths = np.full(MEM_BATCH, MEM_LEN, dtype=np.int32)
    planted = (np.arange(MEM_PLANTED) * (MEM_BATCH // MEM_PLANTED) + 17).astype(np.int64)
    for row, seq in zip(planted, seqs):
        tokens[row, : len(seq)] = seq
        lengths[row] = len(seq)
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)[tokens]
    fasta = tmp / "mem.fsa"
    write_fasta(fasta, [FastaRecord(f"seq{i}", letters[i, : lengths[i]].tobytes().decode())
                        for i in range(MEM_BATCH)])
    p7 = P7Profile.from_profile(load_profile(path))  # as the CLI loads it
    vit = "viterbi_lazy_scan" if p7_cuda.e_skip_d_ok(p7) else "viterbi_scan"
    counts = {}

    out = tmp / "mem_domains.tsv"
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--domains", "--hmm",
                                       str(path), "--fasta", str(fasta), "--device", DEVICE,
                                       "--out", str(out)])
    require(vit == "viterbi_lazy_scan", "the LENG 6977 join runs the eager Viterbi")
    by_c = cluster_launches()
    for name in ("msv_scan", vit, "forward_prob_scan", "forward_save_scan",
                 "backward_coverage_scan"):
        require(got[name + CLUSTER] > 0 and set(by_c[name]) == {3} and got[name + MEM] == 0,
                f"the search --domains did not launch {name}'s 3-block cluster alone ({by_c}, "
                f"{got})")
        counts[name + CLUSTER] = got[name + CLUSTER]
    lines = out.read_text().splitlines()
    header = lines[0].lstrip("# ").split("\t")
    hits = [dict(zip(header, line.split("\t"))) for line in lines[1:]]
    hits = {int(r["target"][3:]): r for r in hits if r["hit"] == "1"}
    for row in planted.tolist():
        r = hits.get(row)
        require(r is not None and int(r["ndom"]) >= 1, f"planted row {row}: no domain")
        require(1 <= int(r["env_from"]) <= int(r["env_to"]) <= int(lengths[row]),
                f"planted row {row}: envelope {r['env_from']}-{r['env_to']} outside "
                f"1-{lengths[row]}")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    print(f"main path rows in memory, search --domains (M {p7.num_states}): {summary}; "
          f"{len(hits)} hits, every planted row (lengths {lengths[planted].tolist()}) a hit with "
          f"its envelope inside it; launches {got}")
    print_seconds("main path rows in memory, search --domains", secs, e2e)

    fast_out = tmp / "mem_fast.tsv"
    got, e2e, secs, _ = run_cli(["scan", "--stage", "search", "--fast", "--hmm", str(path),
                                 "--fasta", str(fasta), "--device", DEVICE, "--out",
                                 str(fast_out)])
    by_c = cluster_launches()
    require(by_c["msv_filter_scan"] == {3: 1}, f"the fast search did not launch the MSV filter's "
            f"3-block cluster ({by_c})")
    for name in ("msv_filter_scan", "viterbi_filter_scan", vit, "forward_prob_scan"):
        require(got[name + CLUSTER] > 0 and set(by_c[name]) == {3} and got[name + MEM] == 0,
                f"the fast search did not launch {name}'s 3-block cluster alone ({by_c}, {got})")
        counts[name + CLUSTER] = counts.get(name + CLUSTER, 0) + got[name + CLUSTER]
    require(set(hit_rows(fast_out)) == {f"seq{r}" for r in hits},
            "the fast search's hits differ from the search's")
    print(f"main path rows in memory, search --fast: the search's {len(hits)} hits; "
          f"launches {got}")
    print_seconds("main path rows in memory, search --fast", secs, e2e)

    out = tmp / "mem_sweep.tsv"
    got, e2e, secs, _ = run_cli(["sweep", "--hmm-dir", str(hmm_dir), "--fasta", str(fasta),
                                 "--device", DEVICE, "--out", str(out)])
    by_c = cluster_launches()
    stacked = by_c["msv_stacked_scan"]
    require(by_c["msv_stacked_scan" + CLUSTER256] == {16: 1} and stacked == {3: 1, 13: 1}
            and got["msv_stacked_scan" + MEM] == 0,
            f"the sweep did not launch the stacked kernel's 3- and 13-block clusters and its "
            f"16-block cluster of 8-warp blocks ({by_c}, {got})")
    counts["msv_stacked_scan" + CLUSTER256] = got["msv_stacked_scan" + CLUSTER256]
    counts["msv_stacked_scan" + CLUSTER] = got["msv_stacked_scan" + CLUSTER]
    rows = [line.split("\t") for line in out.read_text().splitlines() if not line.startswith("#")]
    require(len(rows) == len(joins) * MEM_BATCH and all(np.isfinite(float(r[3])) for r in rows),
            f"the sweep over the joins reported {len(rows)} rows or a non-finite score")
    print(f"main path past 4864 states, sweep over the three joins: {len(rows)} rows; stacked "
          f"cluster launches {stacked}, {by_c['msv_stacked_scan' + CLUSTER256]}; launches {got}")
    print_seconds("main path past 4864 states, sweep", secs, e2e)

    big = hmm_dir / f"mem{len(joins) - 1}.hmm"
    out = tmp / "mem_msv.tsv"
    got, e2e, secs, _ = run_cli(["scan", "--hmm", str(big), "--fasta", str(fasta), "--device",
                                 DEVICE, "--out", str(out)])
    require(got["msv_scan" + CLUSTER256] == 1 and got["msv_scan" + MEM] == 0,
            f"scan past 38,912 states: launches {got}")
    counts["msv_scan" + CLUSTER256] = got["msv_scan" + CLUSTER256]
    rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    require(len(rows) == MEM_BATCH and all(np.isfinite(float(r[2])) for r in rows),
            f"scan past 38,912 states reported {len(rows)} rows or a non-finite score")
    print_seconds(f"main path past 38,912 states (M {joins[-1].model_length - 1}), scan", secs,
                  e2e)
    zero_launches()
    big_msv = MSVProfile.from_profile(load_profile(big))
    scanner = MSVScanner(device=DEVICE)
    staged = scanner.stage(tokens, lengths)
    filt = scanner.scan_filter(big_msv, staged)
    got = launches()
    require(got["msv_filter_scan" + CLUSTER256] == 1 and got["msv_filter_scan" + MEM] == 0,
            f"scan_filter past 38,912 states: launches {got}")
    counts["msv_filter_scan" + CLUSTER256] = got["msv_filter_scan" + CLUSTER256]
    exact = scanner.scan(big_msv, staged)
    require_geq(filt, exact, "MSVScanner.scan_filter past 38,912 states vs scan")
    print(f"main path past 38,912 states: `scan` reported {len(rows)} rows; "
          f"MSVScanner.scan_filter >= scan on every row; launches {got}")

    # the fast cascade past 38,912 states: every row of a FAST_PAST_ROWS
    # slice past MSV (--config msv_p 1), so the Viterbi filter runs on all
    small = tmp / "mem_fast_past.fsa"
    write_fasta(small, [FastaRecord(f"seq{i}", letters[i, : lengths[i]].tobytes().decode())
                        for i in range(FAST_PAST_ROWS)])
    cfg = tmp / "msv_p_1.json"
    cfg.write_text(json.dumps({"msv_p": 1.0}))
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--fast", "--config",
                                       str(cfg), "--hmm", str(big), "--fasta", str(small),
                                       "--device", DEVICE, "--out", str(tmp / "mem_fast_past.tsv")])
    by_c = cluster_launches()
    for name in ("msv_filter_scan", "msv_scan", "viterbi_filter_scan"):
        require(got[name + CLUSTER256] > 0 and got[name + MEM] == 0,
                f"search --fast past 38,912 states did not launch {name}'s cluster of 256-thread "
                f"blocks alone ({by_c}, {got})")
        counts[name + CLUSTER256] = counts.get(name + CLUSTER256, 0) + got[name + CLUSTER256]
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    print(f"main path past 38,912 states (M {joins[-1].model_length - 1}), search --fast with "
          f"msv_p 1 on {FAST_PAST_ROWS} rows: {summary}; launches by C "
          f"{({n: by_c[n + CLUSTER256] for n in ('msv_filter_scan', 'msv_scan', 'viterbi_filter_scan')})}")
    print_seconds("main path past 38,912 states, search --fast", secs, e2e)

    l_max = int(lengths[planted].max())
    zero_launches()
    t0 = time.perf_counter()
    vit_s = viterbi_scores(p7, tokens[planted, :l_max], lengths[planted], device=DEVICE,
                           lazy=False).cpu().numpy()
    log_s = forward_scores(p7, tokens[planted, :l_max], lengths[planted], device=DEVICE,
                           prob_space=False).cpu().numpy()
    got = launches()
    for name in BLOCK_WRAPPERS:
        require(got[name + BLOCK] > 0 and got[name + MEM] == 0,
                f"the entry points did not launch {name}'s wide block alone ({got})")
        counts[name + BLOCK] = got[name + BLOCK]
    require(np.isfinite(vit_s).all() and np.isfinite(log_s).all(),
            "wide block entry points: non-finite scores")
    print(f"main path past 4864 states, entries on the {MEM_PLANTED} planted rows (the wide "
          f"block): Viterbi (eager) "
          f"{np.round(vit_s, 2).tolist()}, log-space Forward {np.round(log_s, 2).tolist()} in "
          f"{time.perf_counter() - t0:.3f} s; launches {got}")

    rows = slice(0, MEM_PLANTED)
    big_p7 = P7Profile.from_profile(load_profile(big))
    require(p7_cuda.default_m_pad(big_p7) > p7_cuda.MAX_CLUSTER_STATES,
            f"M {big_p7.num_states} is not past the 128-thread p7 clusters")
    zero_launches()
    t0 = time.perf_counter()
    lazy_s = viterbi_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE).cpu().numpy()
    eager_s = viterbi_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE,
                             lazy=False).cpu().numpy()
    filt_s = viterbi_filter_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE)
    fwd_s = forward_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE).cpu().numpy()
    log_s = forward_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE,
                           prob_space=False).cpu().numpy()
    cov, _ = posterior_cuda.posterior_coverage_batch(big_p7, tokens[rows], lengths[rows], DEVICE)
    got = launches()
    by_c = cluster_launches()
    c_post = p7_cuda.cluster_blocks(p7_cuda.default_m_pad(big_p7), "save")
    for name in P7_CLUSTER256_WRAPPERS:
        require(got[name + CLUSTER256] > 0 and by_c[name + CLUSTER256] == {
                    c_post: got[name + CLUSTER256]} and got[name + MEM] == 0,
                f"the entry points past 38,912 states did not launch {name}'s cluster of "
                f"{c_post} 256-thread blocks alone ({got}, {by_c[name + CLUSTER256]})")
        counts[name + CLUSTER256] = counts.get(name + CLUSTER256, 0) + got[name + CLUSTER256]
    for name in BLOCKS_WRAPPERS:
        require(got[name + BLOCKS] > 0 and by_c[name + BLOCKS] == {8: got[name + BLOCKS]}
                and got[name + MEM] == 0,
                f"the entry points past 38,912 states did not launch {name}'s cluster of 8 wide "
                f"blocks alone ({got}, {by_c[name + BLOCKS]})")
        counts[name + BLOCKS] = got[name + BLOCKS]
    require_geq(filt_s, torch.from_numpy(lazy_s), "Viterbi filter past 38,912 states vs lazy")
    require(np.array_equal(eager_s, lazy_s), "eager Viterbi past 38,912 states vs lazy")
    require(np.isfinite(lazy_s).all() and np.isfinite(fwd_s).all() and np.isfinite(cov).all()
            and np.isfinite(log_s).all(), "entry points past 38,912 states: non-finite scores")
    print(f"main path past 38,912 states (M {big_p7.num_states}), entries on {MEM_PLANTED} rows: "
          f"lazy Viterbi {np.round(lazy_s, 2).tolist()}, the eager Viterbi == it, the filter >= "
          f"it, Forward {np.round(fwd_s, 2).tolist()}, log-space Forward "
          f"{np.round(log_s, 2).tolist()}, posterior coverage finite, in "
          f"{time.perf_counter() - t0:.3f} s; launches {got}")

    # the route of a card that holds no cluster of wide or 256-thread
    # blocks, LENG 60362: the lazy, Forward, posterior, filter and MSV
    # entries' rows-in-memory cases
    zero_launches()
    with no_block_clusters():
        t0 = time.perf_counter()
        lazy_m = viterbi_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE).cpu().numpy()
        fwd_m = forward_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE).cpu().numpy()
        cov_m, tot_m = posterior_cuda.posterior_coverage_batch(big_p7, tokens[rows], lengths[rows],
                                                               DEVICE)
        filt_m = viterbi_filter_scores(big_p7, tokens[rows], lengths[rows], device=DEVICE)
        exact_m = scanner.scan(big_msv, staged)
        msv_f_m = scanner.scan_filter(big_msv, staged)
        many_m = scanner.scan_many([big_msv], staged)[big_msv.name]
        secs = time.perf_counter() - t0
    got = launches()
    for name in CLUSTER256_WRAPPERS + ("viterbi_lazy_scan",):
        require(got[name + MEM] > 0 and got[name + CLUSTER256 if name in CLUSTER256_WRAPPERS
                                             else name + BLOCKS] == 0,
                f"the entry points with no cluster of wide or 256-thread blocks held did not "
                f"launch {name}'s memory case alone ({got})")
        counts[name + MEM] = got[name + MEM]
    c_err = float(np.abs(cov_m - cov).max())
    f_err = float(np.abs(fwd_m - fwd_s).max())
    same = {"lazy": np.array_equal(lazy_m, lazy_s), "filter": torch.equal(filt_m, filt_s),
            "msv": torch.equal(exact_m, exact), "msv filter": torch.equal(msv_f_m, filt),
            "scan_many": np.array_equal(many_m, exact.cpu().numpy())}
    require(all(same.values()) and f_err <= FWD_TOL and c_err <= COV_TOL,
            f"LENG {big_p7.num_states} entry points: the rows-in-memory route and the clusters "
            f"differ (equal {same}, Forward {f_err}, coverage {c_err})")
    print(f"main path past 38,912 states (M {big_p7.num_states}), the lazy, Forward, posterior "
          f"and filter entries on {MEM_PLANTED} rows and MSVScanner.scan, scan_filter and "
          f"scan_many on {MEM_BATCH} with no cluster of wide or 256-thread blocks held (the "
          f"rows-in-memory route, {secs:.3f} s): lazy, the filter and MSV == the clusters', "
          f"Forward within {f_err:.3g}, coverage within {c_err:.3g}; launches {got}")

    # the route of a card that holds no cluster of wide blocks, LENG 30181
    p7_30181 = P7Profile.from_profile(mem_profiles()[1])
    zero_launches()
    with no_block_clusters():
        t0 = time.perf_counter()
        eager_m = viterbi_scores(p7_30181, tokens[rows], lengths[rows], device=DEVICE,
                                 lazy=False).cpu().numpy()
        log_m = forward_scores(p7_30181, tokens[rows], lengths[rows], device=DEVICE,
                               prob_space=False).cpu().numpy()
        secs = time.perf_counter() - t0
    got = launches()
    for name in BLOCK_WRAPPERS:
        require(got[name + MEM] > 0 and got[name + BLOCKS] == 0,
                f"the entry points with no cluster of wide blocks held did not launch {name}'s "
                f"memory case alone ({got})")
        counts[name + MEM] = got[name + MEM]
    zero_launches()
    eager_b = viterbi_scores(p7_30181, tokens[rows], lengths[rows], device=DEVICE,
                             lazy=False).cpu().numpy()
    log_b = forward_scores(p7_30181, tokens[rows], lengths[rows], device=DEVICE,
                           prob_space=False).cpu().numpy()
    got_b = launches()
    require(np.array_equal(eager_m, eager_b) and np.isfinite(log_m).all()
            and float(np.abs(log_m - log_b).max()) <= 2 * LOG_FWD_TOL,
            "LENG 30181 entry points: the rows-in-memory route and the cluster of wide blocks "
            "differ")
    for name in BLOCK_WRAPPERS:
        require(got_b[name + BLOCKS] > 0 and got_b[name + MEM] == 0,
                f"the LENG 30181 entry points did not launch {name}'s cluster ({got_b})")
        counts[name + BLOCKS] += got_b[name + BLOCKS]
    print(f"main path past 9216 states (M {p7_30181.num_states}), entries on {MEM_PLANTED} rows "
          f"with no cluster of wide blocks held (the rows-in-memory route, {secs:.3f} s): "
          f"Viterbi (eager) {np.round(eager_m, 2).tolist()}, log-space Forward "
          f"{np.round(log_m, 2).tolist()}; == the cluster of 4 wide blocks' (log-space within "
          f"{float(np.abs(log_m - log_b).max()):.3g}); launches {got}, then {got_b}")
    return counts


def msv_timings_past(scanner, msvs: list, staged, suffix: str, reps: int, errors: dict,
                     work: dict) -> dict:
    """MSV and the MSV filter against ``msvs[0]`` and the stacked kernel over
    all of ``msvs`` (one launch each) on ``staged``, best of ``reps`` after a
    warm-up, each plain version once, held against the kernel; the rows
    ``<kernel><suffix>``."""
    out = {}
    rows = staged.num_sequences
    cells = staged.total_residues * msvs[0].num_states
    for name, fmode in (("msv_scan", False), ("msv_filter_scan", True)):
        args = msv_args(scanner, msvs[0], staged, filter_mode=fmode)
        cuda_fn, plain_fn, what = MSV_FNS[fmode]
        ms = best_ms(lambda: cuda_fn(*args), reps=reps)
        got = cuda_fn(*args)
        plain_ms, want = once_ms(lambda: plain_fn(*args))
        err = require_equal(got, want, f"{what}{suffix} kernel vs plain at the timed shape")
        errors[name + suffix] = max(errors[name + suffix], err)
        out[name + suffix] = (ms, plain_ms)
        work[name + suffix] = (OPS_PER_CELL["msv"](0) * cells, nbytes(*args) + nbytes(*want))
        print(f"{name}{suffix}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of {reps}, "
              f"{rows} x {MEM_TIME_LEN} x M={msvs[0].num_states}; plan "
              f"{msv_plan_text(args[0], rows)}); plain version {plain_ms:.3f} ms (once); "
              f"{versus_parent(name + suffix, ms, work)}", flush=True)
    packs = [scanner._stacked_pack((p,), "exact") for p in msvs]
    args = (staged.tokens, staged.lengths, staged.tr_rows)
    ms = best_ms(lambda: [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs],
                 reps=reps)
    got = [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs]
    plain_ms, want = once_ms(lambda: [msv_cuda.msv_stacked_scan_plain(e, *args, c)
                                      for e, c in packs])
    err = require_equal(got, want, f"stacked{suffix} kernel vs plain at the timed shape")
    all_cells = staged.total_residues * sum(p.num_states for p in msvs)
    name = "msv_stacked_scan" + suffix
    errors[name] = max(errors[name], err)
    out[name] = (ms, plain_ms)
    work[name] = (OPS_PER_CELL["msv"](0) * all_cells,
                  nbytes(*args, *(x for pk in packs for x in pk), *got))
    print(f"{name}: {all_cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of {reps}, {rows} x "
          f"{MEM_TIME_LEN} x M {'+'.join(str(p.num_states) for p in msvs)}, {len(packs)} "
          f"launches); plain version {plain_ms:.3f} ms (once); {versus_parent(name, ms, work)}",
          flush=True)
    return out


P7_PAST = (("viterbi_lazy_scan", "lazy"), ("viterbi_scan", "eager"),
           ("forward_prob_scan", "forward"), ("viterbi_filter_scan", "filter"),
           ("forward_log_scan", "log"))


def p7_timings_past(scanner, hmm, tokens, kinds, errors: dict, work: dict,
                    label: str = "", shape: tuple[int, int] | None = None) -> dict:
    """The p7 cases of ``kinds`` (of P7_PAST's, "save" and "backward")
    against ``hmm`` past 4864 states: the Viterbi and Forward kinds at
    ``shape`` (SURVIVOR_BATCH x MEM_TIME_LEN), the posterior pair at
    SURVIVOR_BATCH x POST_TIME_LEN, on the first rows of ``tokens``; a
    C-block cluster, the wide block and a cluster of wide blocks best of 3,
    a rows-in-memory case once, each after a warm-up; each plain version once, held against the
    kernel; the rows ``<kernel>_cluster<label>``, ``<kernel>_block<label>``
    or ``<kernel>_mem<label>`` by the case that ran, the parent's time
    beside each (PARENT_WIDE_MS)."""
    p7 = P7Profile.from_profile(hmm)
    packs = p7_packs(p7, scanner.device)
    rows, length = shape or (SURVIVOR_BATCH, MEM_TIME_LEN)
    few = scanner.stage(tokens[:rows, :length], np.full(rows, length, dtype=np.int32))
    few_cells = few.total_residues * p7.num_states
    out = {}
    for name, kind in P7_PAST:
        if kind not in kinds:
            continue
        pack = packs[kind]
        plan = p7_cuda.device_plan(kind, pack.m_pad, passes_of(kind, pack), rows, DEVICE)
        key = name + case_suffix(plan) + label
        reps = 1 if plan.mem else 3
        run, carry = p7_calls(kind, pack, few)
        ms = best_ms(lambda: run(CUDA_FNS[kind], few.tokens, few.lengths, carry), reps=reps)
        got = run(CUDA_FNS[kind], few.tokens, few.lengths, carry)
        plain_ms, want = once_ms(lambda: run(PLAIN_FNS[kind], few.tokens, few.lengths, carry))
        if kind in ("forward", "log"):
            err = max_abs_diff(got[0], want[0])
            require(err <= FWD_TOL, f"{key} kernel vs plain at the timed shape: {err}")
        else:
            err = require_equal(got, want, f"{key} kernel vs plain at the timed shape")
        row = name + case_suffix(plan)
        errors[row] = max(errors[row], err)
        out[key] = (ms, plain_ms)
        inputs = (*pack[:4], pack.consts, few.tokens, few.lengths, few.tr_rows, *carry)
        work[key] = (OPS_PER_CELL[kind](passes_of(kind, pack)) * few_cells, nbytes(*inputs, *got))
        print(f"{key}: {few_cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of {reps}, "
              f"{rows} x {length} x M={p7.num_states}; "
              f"{plan_text(kind, pack, rows)}); plain version {plain_ms:.3f} ms "
              f"(once), kernel vs plain max|d|={err:.3g}; {versus_parent(key, ms, work)}",
              flush=True)
    if "save" not in kinds:
        return out

    post = scanner.stage(tokens[:SURVIVOR_BATCH, :POST_TIME_LEN],
                         np.full(SURVIVOR_BATCH, POST_TIME_LEN, dtype=np.int32))
    post_cells = post.total_residues * p7.num_states
    fpack = packs["forward"]
    plan = p7_cuda.device_plan("save", fpack.m_pad, passes_of("save", fpack), SURVIVOR_BATCH,
                               DEVICE)
    key = "forward_save_scan" + case_suffix(plan) + label
    fwd_in = (*fpack[:4], post.tokens, post.lengths, post.tr_rows, post.tr_probs, fpack.consts,
              *p7_cuda.forward_init_carry(post.tr_probs, fpack.m_pad))
    reps = 3 if plan.cluster > 1 else 1
    save_ms = best_ms(lambda: posterior_cuda.forward_save_scan_cuda(*fwd_in), reps=reps)
    saved = posterior_cuda.forward_save_scan_cuda(*fwd_in)
    plain_save_ms, p_saved = once_ms(lambda: posterior_cuda.forward_save_scan_plain(*fwd_in))
    t_err = max_abs_diff(saved[0], p_saved[0])
    require(t_err <= TOT_TOL, f"{key} vs plain at the timed shape: {t_err}")
    errors["forward_save_scan" + case_suffix(plan)] = max(
        errors["forward_save_scan" + case_suffix(plan)], t_err)
    out[key] = (save_ms, plain_save_ms)
    work[key] = (OPS_PER_CELL["forward"](fpack.chain.shape[0]) * post_cells,
                 nbytes(*fwd_in, *saved))
    print(f"{key}: the row-saving Forward {save_ms:.3f} ms (best of {reps}, {SURVIVOR_BATCH} x "
          f"{POST_TIME_LEN} x M={p7.num_states}; {plan_text('save', fpack, SURVIVOR_BATCH)}); "
          f"plain version {plain_save_ms:.3f} ms (once), totals max|d|={t_err:.3g}; "
          f"{versus_parent(key, save_ms, work)}", flush=True)
    if "backward" not in kinds:
        return out
    schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
    bwd_in = (fpack.emit_m, fpack.emit_i, fpack.trans, schain, post.tokens, post.lengths,
              post.tr_probs, fpack.consts, saved[0], saved[5], saved[6])
    plan = p7_cuda.device_plan("backward", fpack.m_pad, passes_of("backward", fpack),
                               SURVIVOR_BATCH, DEVICE)
    row = "backward_coverage_scan" + case_suffix(plan)
    key = row + label
    reps = 3 if plan.cluster > 1 else 1
    bwd_ms = best_ms(lambda: posterior_cuda.backward_coverage_scan_cuda(*bwd_in), reps=reps)
    cov = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
    plain_bwd_ms, cov_p = once_ms(lambda: posterior_cuda.backward_coverage_scan_plain(*bwd_in))
    c_err = max_abs_diff(cov, cov_p)
    require(c_err <= COV_TOL, f"{key} vs plain at the timed shape: {c_err}")
    errors[row] = max(errors[row], c_err)
    out[key] = (bwd_ms, plain_bwd_ms)
    work[key] = (OPS_PER_CELL["backward"](schain.shape[0]) * post_cells, nbytes(*bwd_in, cov))
    print(f"{key}: the backward coverage pass {bwd_ms:.3f} ms (best of {reps}, {SURVIVOR_BATCH} x "
          f"{POST_TIME_LEN} x M={p7.num_states}; {plan_text('backward', fpack, SURVIVOR_BATCH)}); "
          f"plain version {plain_bwd_ms:.3f} ms (once), coverage max|d|={c_err:.3g}; "
          f"{versus_parent(key, bwd_ms, work)}", flush=True)
    return out


def mem_timings(scanner, rng, errors: dict, work: dict) -> dict:
    """Each case past 4864 states at MEM_TIME_LEN residues: the MSV
    kernels' C-block clusters (best of 3) against the three-profile join
    (LENG 6977, C = 3) at WIDE_MSV_BATCH rows, MSV and the MSV filter, and
    the stacked kernel over both joins of MEM_JOINS there (C = 3 and 13, two
    launches); the MSV kernels' 16-block cluster of 8-warp blocks (best of
    3) and their rows-in-memory route (once, after a warm-up) against the
    all-24 join twice over (LENG 60362) at MSV_MEM_BATCH rows, the stacked
    kernel over it alone; the p7 cases (p7_timings_past) against
    the three-profile join (the lazy Viterbi, the Viterbi filter, Forward,
    the row-saving Forward and the backward pass on 3-block clusters, the
    eager Viterbi and the log-space Forward on the wide block, these two
    also at CAL_BATCH x CAL_LEN, rows ``<kernel>_block_cal``), the all-24
    join (the five on 13-block clusters, rows ``<kernel>_cluster_30181``,
    the eager and log-space Forward on 4 wide blocks, ``<kernel>_blocks_30181``,
    also at CAL_BATCH x CAL_LEN, ``<kernel>_blocks_cal``, and through the
    rows-in-memory route of a card that holds no such cluster, rows
    ``<kernel>_mem``) and the LENG 60362 join (the eager, log-space and lazy
    kinds on 8 wide blocks, rows ``<kernel>_blocks``, Forward, the posterior
    pair and the Viterbi filter on 13 256-thread blocks,
    ``<kernel>_cluster256``, and the lazy kind, Forward, the posterior pair
    and the filter on the rows-in-memory route of a card that holds no such
    cluster, ``<kernel>_mem``); each plain version once, held against the
    kernel; the parent's time beside each (PARENT_WIDE_MS). Past 38,912
    states MSV runs its 16-block cluster of 8-warp blocks
    (``<kernel>_cluster256``, best of 3) and its rows-in-memory route
    (``<kernel>_mem``, once) and the Viterbi filter its cluster of 13
    256-thread blocks and, once, that route."""
    hmms = mem_profiles()
    # wide enough for the posterior pair's POST_TIME_LEN residues
    tokens = rng.integers(0, 20, size=(WIDE_MSV_BATCH, max(MEM_TIME_LEN, POST_TIME_LEN)))
    tokens = tokens.astype(np.int8)
    staged = scanner.stage(tokens[:, :MEM_TIME_LEN],
                           np.full(WIDE_MSV_BATCH, MEM_TIME_LEN, dtype=np.int32))
    out = msv_timings_past(scanner, [MSVProfile.from_profile(h) for h in hmms], staged, CLUSTER,
                           3, errors, work)
    past = scanner.stage(tokens[:MSV_MEM_BATCH, :MEM_TIME_LEN],
                         np.full(MSV_MEM_BATCH, MEM_TIME_LEN, dtype=np.int32))
    big_msv = [MSVProfile.from_profile(msv_mem_profile())]
    out.update(msv_timings_past(scanner, big_msv, past, CLUSTER256, 3, errors, work))
    with no_block_clusters():
        out.update(msv_timings_past(scanner, big_msv, past, MEM, 1, errors, work))
    clustered = ("lazy", "forward", "filter", "save", "backward")
    blocked = ("eager", "log")
    out.update(p7_timings_past(scanner, hmms[0], tokens, clustered + blocked, errors, work))
    out.update(p7_timings_past(scanner, hmms[0], tokens, blocked, errors, work, "_cal",
                               (CAL_BATCH, CAL_LEN)))
    out.update(p7_timings_past(scanner, hmms[1], tokens, clustered + blocked, errors, work,
                               "_30181"))
    out.update(p7_timings_past(scanner, hmms[1], tokens, blocked, errors, work, "_cal",
                               (CAL_BATCH, CAL_LEN)))
    with no_block_clusters():
        out.update(p7_timings_past(scanner, hmms[1], tokens, blocked, errors, work))
    big = msv_mem_profile()
    out.update(p7_timings_past(scanner, big, tokens, clustered + blocked, errors, work))
    with no_block_clusters():
        out.update(p7_timings_past(scanner, big, tokens,
                                   ("lazy", "forward", "filter", "save", "backward"), errors,
                                   work))
    post_chunk_timings(scanner, big, tokens)
    return out


def post_chunk_timings(scanner, hmm, tokens) -> None:
    """The posterior pair against ``hmm`` (past 38,912 states) at the
    sequences of one posterior_coverage_batch call at POST_TIME_LEN
    residues (post_chunk: 26 at LENG 60362), on the first rows of
    ``tokens``: the row-saving Forward, then the backward pass on its rows,
    each once after a warm-up, on the cluster of 256-thread blocks and on
    the rows-in-memory route (no_block_clusters); printed."""
    p7 = P7Profile.from_profile(hmm)
    rows = post_chunk(p7)
    staged = scanner.stage(tokens[:rows, :POST_TIME_LEN],
                           np.full(rows, POST_TIME_LEN, dtype=np.int32))
    fpack = p7_cuda.forward_pack(p7, scanner.device)
    schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
    fwd_in = (*fpack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
              fpack.consts, *p7_cuda.forward_init_carry(staged.tr_probs, fpack.m_pad))
    text = []
    for route, ctx in (("cluster256", contextlib.nullcontext), ("mem", no_block_clusters)):
        with ctx():
            save_ms = best_ms(lambda: posterior_cuda.forward_save_scan_cuda(*fwd_in), reps=1)
            saved = posterior_cuda.forward_save_scan_cuda(*fwd_in)
            bwd_in = (fpack.emit_m, fpack.emit_i, fpack.trans, schain, staged.tokens,
                      staged.lengths, staged.tr_probs, fpack.consts, saved[0], saved[5], saved[6])
            bwd_ms = best_ms(lambda: posterior_cuda.backward_coverage_scan_cuda(*bwd_in), reps=1)
            plan = p7_cuda.device_plan("save", fpack.m_pad, passes_of("save", fpack), rows, DEVICE)
            del saved, bwd_in
        text.append(f"{route}: the row-saving Forward {save_ms:.3f} ms, the backward pass "
                    f"{bwd_ms:.3f} ms (grid {plan.grid}, {plan.threads} threads x {plan.per}, "
                    f"cluster {plan.cluster})")
    print(f"posterior_chunk_{p7.num_states}: one posterior_coverage_batch chunk, {rows} x "
          f"{POST_TIME_LEN} x M={p7.num_states}, once each after a warm-up; "
          f"{'; '.join(text)}", flush=True)


# -- main paths (phase 9) ------------------------------------------------------

def planted_rows() -> np.ndarray:
    """The rows of the headline database that hold the 1400.hmm homologs."""
    stride = BATCH // PLANTED
    return (np.arange(PLANTED) * stride + stride // 3).astype(np.int64)


def write_database(rng, path: pathlib.Path):
    """16384 random sequences of 3500 residues with PLANTED sequences
    sampled from 1400.hmm and WIDE_PLANTED from the wider of the wide
    profiles (cut at 3500 residues) at known rows; returns (tokens, lengths,
    rows, wide rows)."""
    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    lengths = np.full(BATCH, SEQ_LEN, dtype=np.int32)
    stride = BATCH // PLANTED
    rows = planted_rows()
    wide_rows = (np.arange(WIDE_PLANTED) * stride + 2 * stride // 3).astype(np.int64)
    for planted, hmm, n in ((rows, parse_hmm(PROFILES / "1400.hmm"), PLANTED),
                            (wide_rows, wide_profile(WIDE_PAIRS[1]), WIDE_PLANTED)):
        for row, seq in zip(planted, sample_sequences(hmm, n, seed=SEED)):
            seq = seq[:SEQ_LEN]
            tokens[row, : len(seq)] = seq
            lengths[row] = len(seq)
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)[tokens]
    write_fasta(path, [
        FastaRecord(f"seq{i}", letters[i, : lengths[i]].tobytes().decode()) for i in range(BATCH)
    ])
    return tokens, lengths, rows, wide_rows


def run_cli(argv):
    """One CLI run with every launch count set to 0 before it: (launches,
    end-to-end seconds, the `seconds:` line's values or None for a command
    without one, the records of the port's loggers)."""
    handler = _Records()
    package = logging.getLogger("hmm_fasta_viterbi_tpu_torch")
    package.addHandler(handler)
    zero_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    e2e = time.perf_counter() - t0
    counts = launches()
    package.removeHandler(handler)
    require(rc == 0, f"{' '.join(argv[:3])} exited {rc}")
    phases = next((r for r in handler.records if r.msg.startswith("seconds:")), None)
    return counts, e2e, phases.args if phases is not None else None, handler.records


def print_seconds(label, args, e2e) -> None:
    parse_s, stage_s, msv_s, vit_s, fwd_s, dom_s, report_s, total_s = args
    print(f"{label} seconds: parse {parse_s:.3f} stage {stage_s:.3f} msv {msv_s:.3f} "
          f"viterbi {vit_s:.3f} forward {fwd_s:.3f} domains {dom_s:.3f} report {report_s:.3f} "
          f"cli total {total_s:.3f} end-to-end {e2e:.3f}")


def main_paths(tmp: pathlib.Path, rng, scanner) -> dict:
    fasta = tmp / "headline.fsa"
    t0 = time.perf_counter()
    tokens, lengths, planted, planted_wide = write_database(rng, fasta)
    print(f"wrote {fasta.stat().st_size} bytes of FASTA ({PLANTED} planted homologs of "
          f"1400.hmm, lengths {int(lengths[planted].min())}-{int(lengths[planted].max())}) "
          f"in {time.perf_counter() - t0:.2f} s")
    hmm = str(PROFILES / "1400.hmm")
    counts = {}

    # scan --stage msv
    out = tmp / "scan.tsv"
    got, e2e, secs, _ = run_cli(["scan", "--hmm", hmm, "--fasta", str(fasta),
                                 "--device", DEVICE, "--out", str(out)])
    require(got["msv_scan"] > 0, "the MSV scan did not launch the MSV kernel")
    counts["msv_scan"] = got["msv_scan"]
    rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    require(len(rows) == BATCH, f"{len(rows)} report rows, expected {BATCH}")
    require(all(np.isfinite(float(r[2])) for r in rows), "non-finite score in the report")
    top = np.array([int(r[0][3:]) for r in rows[:8]])
    # the profile as the CLI loads it (the native parser, where built, can
    # differ from parse_hmm in the last bit)
    cli_profile = MSVProfile.from_profile(load_profile(hmm))
    want = msv_oracle_batch(cli_profile, tokens[top].astype(np.int32), lengths[top])
    for r, w in zip(rows[:8], want):
        require(r[2] == str(round(float(w), 4)), f"report row {r[0]}: {r[2]} != oracle {w}")
    print(f"main path msv: scan {BATCH} x {SEQ_LEN} vs 1400.hmm via the CLI: {len(rows)} rows, "
          f"launches {got}, top 8 equal to the oracle")
    print_seconds("main path msv", secs, e2e)

    # scan --stage search
    out = tmp / "search.tsv"
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--hmm", hmm, "--fasta",
                                       str(fasta), "--device", DEVICE, "--out", str(out)])
    require(got["msv_scan"] > 0, "the search did not launch the MSV kernel")
    require(got["viterbi_lazy_scan"] > 0, "the search did not launch the lazy Viterbi kernel")
    require(got["forward_prob_scan"] > 0, "the search did not launch the Forward kernel")
    counts["viterbi_lazy_scan"] = got["viterbi_lazy_scan"]
    counts["forward_prob_scan"] = got["forward_prob_scan"]
    rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
    hits = {int(r[0][3:]) for r in rows if r[7] == "1"}
    missed = sorted(set(planted.tolist()) - hits)
    require(not missed, f"planted homologs not reported as hits: rows {missed}")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    require(all(np.isfinite(float(r[2])) for r in rows), "non-finite msv_bits in the report")
    print(f"main path search: {summary}; {len(rows)} report rows, {len(hits)} hits, all "
          f"{PLANTED} planted rows among them; launches {got}")
    print_seconds("main path search", secs, e2e)

    # scan --stage viterbi / forward: every row scored, the planted ones on top
    for stage, kernel in (("viterbi", "viterbi_lazy_scan"), ("forward", "forward_prob_scan")):
        out = tmp / f"{stage}.tsv"
        got, e2e, secs, _ = run_cli(["scan", "--stage", stage, "--hmm", hmm, "--fasta",
                                     str(fasta), "--device", DEVICE, "--out", str(out)])
        require(got[kernel] > 0, f"scan --stage {stage} did not launch {kernel}")
        rows = [line.split("\t") for line in out.read_text().splitlines()[1:]]
        require(len(rows) == BATCH and all(np.isfinite(float(r[2])) for r in rows),
                f"scan --stage {stage}: {len(rows)} rows or a non-finite score")
        top = {int(r[0][3:]) for r in rows[:PLANTED]}
        require(top == set(planted.tolist()), f"scan --stage {stage}: planted rows not on top")
        print(f"main path {stage}: {len(rows)} rows, the {PLANTED} planted rows on top, "
              f"launches {got}")
        print_seconds(f"main path {stage}", secs, e2e)

    # the single-stage Viterbi entry, eager kernel, at the stage shape
    zero_launches()
    t0 = time.perf_counter()
    scores = viterbi_scores(p7_profile("1400"), tokens[:STAGE_BATCH], lengths[:STAGE_BATCH],
                            device=DEVICE, lazy=False).cpu().numpy()
    got = launches()
    require(got["viterbi_scan"] > 0, "viterbi_scores(lazy=False) did not launch the eager kernel")
    require(np.isfinite(scores).all() and scores.shape == (STAGE_BATCH,),
            "eager Viterbi entry: non-finite scores or wrong shape")
    counts["viterbi_scan"] = got["viterbi_scan"]
    print(f"main path viterbi entry (lazy=False): {STAGE_BATCH} x <= {SEQ_LEN} vs 1400.hmm in "
          f"{time.perf_counter() - t0:.3f} s, launches {got}")

    # scan --stage search --fast: the prefilters, then the exact stages
    out = tmp / "search_fast.tsv"
    got, e2e, secs, records = run_cli(["scan", "--stage", "search", "--fast", "--hmm", hmm,
                                       "--fasta", str(fasta), "--device", DEVICE, "--out",
                                       str(out)])
    for name in ("msv_filter_scan", "msv_scan", "viterbi_filter_scan", "viterbi_lazy_scan",
                 "forward_prob_scan"):
        require(got[name] > 0, f"the fast search did not launch {name}")
    counts["msv_filter_scan"] = got["msv_filter_scan"]
    counts["viterbi_filter_scan"] = got["viterbi_filter_scan"]
    plain_hits = hit_rows(tmp / "search.tsv")
    fast_hits = hit_rows(out)
    require(set(fast_hits) == set(plain_hits), "the fast search's hits differ from the search's")
    require(fast_hits == plain_hits, "the fast search's hit rows differ from the search's")
    require(set(planted.tolist()) <= {int(t[3:]) for t in fast_hits},
            "the fast search missed a planted homolog")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    print(f"main path search --fast: {summary}; {len(fast_hits)} hits, equal to the search's "
          f"hit rows, all {PLANTED} planted rows among them; launches {got}")
    print_seconds("main path search --fast", secs, e2e)

    # sweep (msv) over the 24 profiles: the stacked kernel
    out = tmp / "sweep.tsv"
    got, e2e, secs, records = run_cli(["sweep", "--hmm-dir", str(PROFILES), "--fasta",
                                       str(fasta), "--device", DEVICE, "--out", str(out)])
    require(got["msv_stacked_scan"] > 0, "the sweep did not launch the stacked MSV kernel")
    counts["msv_stacked_scan"] = got["msv_stacked_scan"]
    name_1400 = load_profile(hmm).name
    sweep_rows = [line for line in out.read_text().splitlines()
                  if not line.startswith("#") and line.split("\t")[1] == name_1400]
    scan_rows = (tmp / "scan.tsv").read_text().splitlines()[1:]
    require(sweep_rows == scan_rows, "the sweep's 1400.hmm rows differ from scan's report")
    n_rows = sum(1 for line in out.read_text().splitlines() if not line.startswith("#"))
    require(n_rows == 24 * BATCH, f"the sweep reported {n_rows} rows, expected {24 * BATCH}")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("swept "))
    print(f"main path sweep: {summary}; {n_rows} rows, the 1400.hmm rows equal to scan's; "
          f"launches {got}")
    print_seconds("main path sweep", secs, e2e)

    # sweep --stage search --fast over the 24 profiles: both filter kernels
    out = tmp / "sweep_search.tsv"
    got, e2e, secs, records = run_cli(["sweep", "--stage", "search", "--fast", "--hmm-dir",
                                       str(PROFILES), "--fasta", str(fasta), "--device", DEVICE,
                                       "--out", str(out)])
    for name in ("msv_filter_scan", "viterbi_filter_scan"):
        require(got[name] > 0, f"the fast search sweep did not launch {name}")
    lines = [r.getMessage() for r in records if r.getMessage().startswith("search ")]
    require(len(lines) == 24, f"{len(lines)} survivor lines, expected 24")
    sweep_hits = {t for (t, prof) in hit_rows(out, with_profile=True) if prof == name_1400}
    require(sweep_hits == set(fast_hits), "the sweep's 1400.hmm hits differ from the search's")
    print("main path sweep search --fast, survivors per profile:")
    for line in lines:
        print(f"  {line}")
    print(f"  launches {got}")
    print_seconds("main path sweep search --fast", secs, e2e)

    got = domains_path(tmp, fasta, tokens, lengths, planted, scanner)
    counts["forward_save_scan"] = got["forward_save_scan"]
    counts["backward_coverage_scan"] = got["backward_coverage_scan"]
    counts["forward_log_scan"] = long_l_referee(rng)["forward_log_scan"]
    counts.update(wide_paths(tmp, fasta, tokens, lengths, planted_wide))
    return counts


def hit_rows(path: pathlib.Path, with_profile: bool = False) -> dict:
    """The report rows of a search report's hits, keyed by target (and
    profile)."""
    out = {}
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        row = line.split("\t")
        if row[7] == "1":
            out[(row[0], row[1]) if with_profile else row[0]] = line
    return out


# -- database-scale paths (phase 11) -------------------------------------------

def run_cli_logged(argv):
    """:func:`run_cli` with the messages of its log records."""
    counts, e2e, secs, records = run_cli(argv)
    return counts, e2e, secs, [r.getMessage() for r in records]


def phase_ms(messages: list, label: str) -> dict:
    """The sections of a streamed command's phase line, in ms."""
    line = next(m for m in messages if m.startswith(f"streamed {label} phases:"))
    return {k: float(v) for k, v in re.findall(r"(\S+)=([0-9.]+)ms", line)}


def side_stream(messages: list, batches: int, what: str) -> str:
    """Require that the streamed batches were staged on a stream other than
    the consumer's; the log line of the stager."""
    line = next((m for m in messages if m.startswith("side-stream staging:")), None)
    require(line is not None, f"{what}: no side-stream staging line")
    n, side, consumer = re.match(
        r"side-stream staging: (\d+) batches staged on stream (\S+), consumed on stream (\S+)",
        line).groups()
    require(int(n) == batches, f"{what}: {n} batches staged on the side stream, "
                               f"expected {batches}")
    require(side != consumer, f"{what}: batches staged on the consumer's stream {consumer}")
    return line


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def streamed_paths(db: pathlib.Path, fasta: pathlib.Path, planted) -> None:
    """`--stream 4096` against its whole-file run on phase 9's database, in
    turns (whole, streamed), reports byte-equal: `scan --stage search
    --domains` (also byte-equal to phase 9's report; every planted row a
    hit), `scan` (msv), `scan --stage search --fast`, `sweep` and `sweep
    --stage search --fast` over the 24 profiles. Each streamed run stages
    its BATCH // STREAM_BATCH batches on the side stream (the MSV kernel
    launched once a batch at least) and prints its phase line, producer
    stage and prefetch wait beside the two end-to-end times."""
    hmm = str(PROFILES / "1400.hmm")
    batches = -(-BATCH // STREAM_BATCH)
    runs = [
        ("scan --stage search --domains", ["scan", "--stage", "search", "--domains", "--hmm", hmm],
         "domains.tsv", "search"),
        ("scan", ["scan", "--hmm", hmm], "scan.tsv", "scan"),
        ("scan --stage search --fast", ["scan", "--stage", "search", "--fast", "--hmm", hmm],
         "search_fast.tsv", "search"),
        ("sweep", ["sweep", "--hmm-dir", str(PROFILES)], "sweep.tsv", "sweep"),
        ("sweep --stage search --fast",
         ["sweep", "--stage", "search", "--fast", "--hmm-dir", str(PROFILES)],
         "sweep_search.tsv", "search"),
    ]
    for label, argv, phase9, kind in runs:
        common = [*argv, "--fasta", str(fasta), "--device", DEVICE]
        whole, streamed = db / f"whole_{phase9}", db / f"stream_{phase9}"
        _, whole_e2e, whole_secs, _ = run_cli_logged([*common, "--out", str(whole)])
        got, e2e, secs, messages = run_cli_logged(
            [*common, "--stream", str(STREAM_BATCH), "--out", str(streamed)])
        require(whole.read_bytes() == (fasta.parent / phase9).read_bytes(),
                f"{label}: the whole-file report differs from phase 9's")
        require(streamed.read_bytes() == whole.read_bytes(),
                f"{label} --stream: the report differs from the whole-file one")
        kernel = "msv_stacked_scan" if label == "sweep" else (
            "msv_filter_scan" if "--fast" in argv else "msv_scan")
        require(got[kernel] >= batches, f"{label} --stream: {got[kernel]} {kernel} launches "
                                        f"for {batches} batches")
        line = side_stream(messages, batches, f"{label} --stream")
        ms = phase_ms(messages, kind)
        print(f"database {label} --stream {STREAM_BATCH}: report byte-equal to the whole-file "
              f"one; {line}; launches {nonzero(got)}")
        print(f"  phases: {next(m for m in messages if m.startswith('streamed '))}")
        print(f"  producer/stage {ms['producer/stage']:.1f} ms, prefetch_wait "
              f"{ms['prefetch_wait']:.1f} ms, producer/parse {ms['producer/parse']:.1f} ms; "
              f"end to end streamed {e2e:.3f} s, whole-file {whole_e2e:.3f} s")
        print_seconds(f"  whole-file {label}", whole_secs, whole_e2e)
        print_seconds(f"  streamed {label}", secs, e2e)
        if "--domains" in argv:
            hits = {int(t[3:]) for t in hit_rows(streamed)}
            missed = sorted(set(planted.tolist()) - hits)
            require(not missed, f"streamed --domains: planted rows not hits: {missed}")


def skewed_residues() -> tuple[np.ndarray, np.ndarray]:
    """The length-skewed database: SKEW_BATCH lengths from a seeded
    lognormal (median SKEW_MEDIAN, sigma SKEW_SIGMA) clipped to SKEW_CLIP,
    and all their residues (tokens), one sequence after the other."""
    rng = np.random.default_rng(SEED + 11)
    lengths = np.clip(np.round(rng.lognormal(math.log(SKEW_MEDIAN), SKEW_SIGMA, SKEW_BATCH)),
                      *SKEW_CLIP).astype(np.int64)
    return lengths, rng.integers(0, 20, size=int(lengths.sum()))


def skewed_batch() -> tuple[np.ndarray, np.ndarray]:
    """The length-skewed database as an int8 ``[B, L_max]`` batch and its
    int32 lengths."""
    lengths, residues = skewed_residues()
    tokens = np.zeros((len(lengths), int(lengths.max())), dtype=np.int8)
    tokens[np.arange(tokens.shape[1])[None, :] < lengths[:, None]] = residues
    return tokens, lengths.astype(np.int32)


def write_skewed_database(path: pathlib.Path) -> np.ndarray:
    """The length-skewed database (:func:`skewed_residues`) as a FASTA
    file; returns the lengths."""
    lengths, residues = skewed_residues()
    letters = np.frombuffer(AMINO_ACIDS.encode(), dtype=np.uint8)[residues].tobytes().decode()
    ends = np.cumsum(lengths)
    write_fasta(path, [FastaRecord(f"seq{i}", letters[e - n: e])
                       for i, (n, e) in enumerate(zip(lengths, ends))])
    return lengths


def bucketed_paths(db: pathlib.Path) -> None:
    """`--bucketed` against the unbucketed run on a length-skewed database,
    in turns, reports byte-equal: `scan`, `scan --stage search`, `scan
    --stage search --fast` and `sweep` over the 24 profiles; prints the
    bucket count, the padded cells saved and both runs' seconds."""
    fasta = db / "skewed.fsa"
    lengths = write_skewed_database(fasta)
    print(f"skewed database: {SKEW_BATCH} sequences, lengths {int(lengths.min())}-"
          f"{int(lengths.max())}, median {float(np.median(lengths)):.0f}, "
          f"{int(lengths.sum())} residues")
    hmm = str(PROFILES / "1400.hmm")
    runs = [
        ("scan", ["scan", "--hmm", hmm]),
        ("scan --stage search", ["scan", "--stage", "search", "--hmm", hmm]),
        ("scan --stage search --fast", ["scan", "--stage", "search", "--fast", "--hmm", hmm]),
        ("sweep", ["sweep", "--hmm-dir", str(PROFILES)]),
    ]
    for k, (label, argv) in enumerate(runs):
        common = [*argv, "--fasta", str(fasta), "--device", DEVICE]
        whole, bucketed = db / f"skew{k}.tsv", db / f"skew{k}_bucketed.tsv"
        _, whole_e2e, whole_secs, _ = run_cli_logged([*common, "--out", str(whole)])
        got, e2e, secs, messages = run_cli_logged([*common, "--bucketed", "--out",
                                                   str(bucketed)])
        require(bucketed.read_bytes() == whole.read_bytes(),
                f"{label} --bucketed: the report differs from the unbucketed one")
        line = next(m for m in messages if m.startswith("bucketed staging:"))
        n_buckets = int(line.split()[2])
        require(n_buckets > 1, f"{label} --bucketed: {line}")
        rows = sum(1 for r in whole.read_text().splitlines() if not r.startswith("#"))
        print(f"database {label} --bucketed: report byte-equal to the unbucketed one ({rows} "
              f"rows); {line}; launches {nonzero(got)}")
        print_seconds(f"  unbucketed {label}", whole_secs, whole_e2e)
        print_seconds(f"  bucketed {label}", secs, e2e)


def checkpoint_paths(db: pathlib.Path, fasta: pathlib.Path) -> None:
    """`sweep --checkpoint DIR --checkpoint-shard 4096` (msv, and `--stage
    search --fast`) over phase 9's database and the 24 profiles: the report
    byte-equal to phase 9's uncheckpointed sweep; then one profile's chunk
    of shard 2 and every chunk of shard 3 deleted and the sweep rerun: the
    report byte-equal again, only the deleted chunks recomputed (the log's
    chunk lines and count, every other chunk file untouched)."""
    shards = -(-BATCH // CHECKPOINT_SHARD)
    names = [load_profile(p).name for p in sorted(PROFILES.glob("*.hmm"))]
    one = load_profile(PROFILES / "1400.hmm").name
    for label, stage, phase9 in (("sweep", [], "sweep.tsv"),
                                 ("sweep --stage search --fast",
                                  ["--stage", "search", "--fast"], "sweep_search.tsv")):
        ckpt = db / f"ckpt_{phase9[:-4]}"
        argv = ["sweep", *stage, "--hmm-dir", str(PROFILES), "--fasta", str(fasta), "--device",
                DEVICE, "--checkpoint", str(ckpt), "--checkpoint-shard", str(CHECKPOINT_SHARD)]
        out = db / f"ckpt_{phase9}"
        _, first_e2e, first_secs, _ = run_cli_logged([*argv, "--out", str(out)])
        require(out.read_bytes() == (fasta.parent / phase9).read_bytes(),
                f"{label} --checkpoint: the report differs from phase 9's")
        chunks = sorted(ckpt.glob("*.npz"))
        require(len(chunks) == shards * len(names),
                f"{label} --checkpoint: {len(chunks)} chunks, expected {shards * len(names)}")
        deleted = [ckpt / f"{one}.shard00002.npz", *ckpt.glob("*.shard00003.npz")]
        kept = {p: p.stat().st_mtime_ns for p in chunks if p not in deleted}
        for p in deleted:
            p.unlink()
        got, e2e, secs, messages = run_cli_logged([*argv, "--out", str(out)])
        require(out.read_bytes() == (fasta.parent / phase9).read_bytes(),
                f"{label} --checkpoint rerun: the report differs from phase 9's")
        recomputed = [m for m in messages if m.startswith("checkpointed")]
        if stage:
            want = [f"checkpointed search {one} shard 3/{shards}"] + [
                f"checkpointed search {n} shard 4/{shards}" for n in names]
            require(sorted(recomputed) == sorted(want),
                    f"{label} --checkpoint rerun recomputed {recomputed}")
        else:
            require(recomputed == [f"checkpointed shard 3/{shards} (1 profiles)",
                                   f"checkpointed shard 4/{shards} ({len(names)} profiles)"],
                    f"{label} --checkpoint rerun recomputed {recomputed}")
        summary = next(m for m in messages if m.startswith("checkpoint "))
        require(summary.endswith(f"{len(deleted)} chunks computed, "
                                 f"{len(chunks) - len(deleted)} read back"), summary)
        require(all(p.stat().st_mtime_ns == t for p, t in kept.items()),
                f"{label} --checkpoint rerun rewrote a chunk it kept")
        print(f"database {label} --checkpoint: report byte-equal to phase 9's; {len(deleted)} "
              f"of {len(chunks)} chunks deleted and recomputed, no other chunk rewritten; "
              f"{summary}; launches {nonzero(got)}")
        print_seconds(f"  first {label} --checkpoint", first_secs, first_e2e)
        print_seconds(f"  resumed {label} --checkpoint", secs, e2e)


def database_paths(tmp: pathlib.Path) -> None:
    db = tmp / "database"
    db.mkdir()
    fasta = tmp / "headline.fsa"
    streamed_paths(db, fasta, planted_rows())
    bucketed_paths(db)
    checkpoint_paths(db, fasta)


# -- host subcommands, alignments, --config and --profile-trace (phase 12) ----

STATS_LINES = ("STATS LOCAL MSV", "STATS LOCAL VITERBI", "STATS LOCAL FORWARD")


def stats_text(hmm) -> str:
    return (f"MSV mu {hmm.stats_local_msv_mu:.4f} lambda {hmm.stats_local_msv_lambda:.5f}, "
            f"Viterbi mu {hmm.stats_local_viterbi_mu:.4f}, "
            f"Forward tau {hmm.stats_local_forward_theta:.4f}")


def require_stats_close(got, want, what: str) -> float:
    """build's STATS against the plain versions': mu within MU_TOL, tau
    within TAU_TOL, every lambda equal; returns the largest difference."""
    diffs = {
        "msv mu": (got.stats_local_msv_mu - want.stats_local_msv_mu, MU_TOL),
        "viterbi mu": (got.stats_local_viterbi_mu - want.stats_local_viterbi_mu, MU_TOL),
        "forward tau": (got.stats_local_forward_theta - want.stats_local_forward_theta, TAU_TOL),
    }
    for name, (d, tol) in diffs.items():
        require(abs(d) <= tol, f"{what}: {name} differs by {d:.3g} bits (tolerance {tol})")
    for name in ("msv_lambda", "viterbi_lambda", "forward_lambda"):
        require(getattr(got, f"stats_local_{name}") == getattr(want, f"stats_local_{name}"),
                f"{what}: {name} differs")
    return max(abs(d) for d, _ in diffs.values())


def traced(fn, label: str, trace_dir: pathlib.Path):
    """``fn()`` under a device trace, its call labelled ``label``: (result,
    kernel µs summed, the trace's busy share over the labelled window,
    the window µs)."""
    with profiling.device_trace(str(trace_dir), DEVICE):
        with torch.profiler.record_function(label):
            out = fn()
    trace = json.loads(max(trace_dir.glob("*.pt.trace.json"), key=lambda f: f.stat().st_mtime)
                       .read_text())
    kernels = profiling.kernel_events(trace)
    require(kernels, f"{label}: the trace holds no CUDA kernel event (CUPTI recorded none)")
    share, window = profiling.busy_share(trace, labels=(label,))
    return out, sum(float(k.get("dur", 0)) for k in kernels), share, window


def build_path(tmp: pathlib.Path) -> None:
    """`emit` BUILD_SAMPLES samples of 1400.hmm, `align --format stockholm`
    them and `build` the MSA on the card (the MSV, eager Viterbi and
    log-space Forward kernels each launched) and through the plain versions
    (--device cpu): the files equal apart from their STATS lines, which
    agree within MU_TOL / TAU_TOL; the card's calibration traced; then
    calibrate_profile on the LENG 4770 join (the three kernels' wide
    cases) and on the LENG 6977 and 30181 joins against the plain
    versions."""
    src = str(PROFILES / "1400.hmm")
    samples, msa = tmp / "build_samples.fsa", tmp / "build.sto"
    run_cli(["emit", "--hmm", src, "--count", str(BUILD_SAMPLES), "--seed", str(SEED),
             "--out", str(samples)])
    _, e2e, _, _ = run_cli(["align", "--hmm", src, "--fasta", str(samples), "--format",
                            "stockholm", "--out", str(msa)])
    print(f"align --format stockholm: {BUILD_SAMPLES} samples of 1400.hmm in {e2e:.3f} s")
    built = {}
    for device in (DEVICE, "cpu"):
        out = tmp / f"built_{device.replace(':', '')}.hmm"
        got, e2e, _, records = run_cli(["build", "--msa", str(msa), "--out", str(out),
                                        "--device", device])
        line = next(r.getMessage() for r in records if r.getMessage().startswith("built "))
        if device == DEVICE:
            for name in CALIBRATION_KERNELS:
                require(got[name] >= 1, f"build --device {device} did not launch {name}")
        else:
            require(not nonzero(got), f"build --device cpu launched kernels: {nonzero(got)}")
        built[device] = out
        print(f"build --device {device}: {line}; end to end {e2e:.3f} s; launches "
              f"{nonzero(got)}")
    card_text, plain_text = (built[d].read_text().splitlines() for d in (DEVICE, "cpu"))
    require([x for x in card_text if not x.startswith(STATS_LINES)]
            == [x for x in plain_text if not x.startswith(STATS_LINES)],
            "build: the card's file differs from the plain versions' outside the STATS lines")
    card, plain = parse_hmm(built[DEVICE]), parse_hmm(built["cpu"])
    err = require_stats_close(card, plain, "build 1400.hmm samples")
    print(f"build: files equal apart from STATS; card {stats_text(card)}; plain "
          f"{stats_text(plain)}; max |d| {err:.3g} bits")

    hmm = card
    zero_launches()
    (_, kernel_us, share, window) = traced(
        lambda: calibrate_profile(hmm, seed=SEED, device=DEVICE), "calibrate", tmp / "cal_trace")
    print(f"calibrate_profile (LENG {hmm.model_length - 1}, 256 x "
          f"{min(400, max(100, hmm.model_length - 1))}) traced: kernels {kernel_us / 1e3:.3f} ms "
          f"of a {window / 1e3:.3f} ms call, device busy share {share:.4f}")

    # the wide cases, each held against its plain version in phase 8
    wide = wide_profile(WIDE_PAIRS[1])
    zero_launches()
    t0 = time.perf_counter()
    got_wide = calibrate_profile(wide, seed=SEED, device=DEVICE)
    card_s = time.perf_counter() - t0
    got = launches()
    for name in CALIBRATION_KERNELS:
        require(got[name + WIDE] >= 1, f"the LENG 4770 calibration did not launch {name}'s "
                                       "wide case")
    require(all(np.isfinite([got_wide.stats_local_msv_mu, got_wide.stats_local_viterbi_mu,
                             got_wide.stats_local_forward_theta])),
            "the LENG 4770 calibration: non-finite STATS")
    print(f"calibrate_profile LENG 4770 (256 x 400) on the card: {card_s:.3f} s; "
          f"{stats_text(got_wide)}; launches {nonzero(got)}")

    # past 4864 states: MSV's 3- and 13-block clusters and the eager and
    # log-space wide block (LENG 6977) and cluster of 4 wide blocks (LENG
    # 30181), against the same calibration through the plain versions
    for join, case in zip(mem_profiles(), (BLOCK, BLOCKS)):
        leng = join.model_length - 1
        zero_launches()
        t0 = time.perf_counter()
        got_join = calibrate_profile(join, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        got = launches()
        require(got["msv_scan" + CLUSTER] >= 1, f"the LENG {leng} calibration: launches {got}")
        for name in BLOCK_WRAPPERS:
            require(got[name + case] >= 1 and got[name + MEM] == 0,
                    f"the LENG {leng} calibration did not launch {name}{case} alone ({got})")
        t0 = time.perf_counter()
        with plain_scans():
            want_join = calibrate_profile(join, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = require_stats_close(got_join, want_join, f"calibrate_profile LENG {leng}")
        print(f"calibrate_profile LENG {leng} (256 x 400) on the card: {card_s:.3f} s (the "
              f"plain versions on the card: {plain_s:.3f} s); {stats_text(got_join)}; plain "
              f"{stats_text(want_join)}; max |d| {err:.3g} bits; launches {nonzero(got)}")


@contextlib.contextmanager
def plain_scans():
    """The MSV, eager Viterbi and log-space Forward kernel wrappers (build's
    calibration) replaced by their plain versions, which take CUDA tensors:
    a plain reference of the calibration on the card, on the same tensors."""
    swaps = ((msv_cuda, "msv_scan_cuda", msv_cuda.msv_scan_plain),
             (p7_cuda, "viterbi_scan_cuda", p7_cuda.viterbi_scan_plain),
             (p7_cuda, "forward_log_scan_cuda", p7_cuda.forward_log_scan_plain))
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def alignment_rows(path: pathlib.Path) -> dict:
    return {r["target"]: r for r in json.loads(path.read_text())}


def align_paths(tmp: pathlib.Path, tokens, lengths, planted) -> None:
    """`scan --stage search --align --msa-out` on phase 9's database: every
    planted row a hit with an alignment inside its sequence, the MSA one
    row a domain; with --domains the rows keep their envelopes; --stream
    4096 byte-equal to the whole-file report and MSA."""
    fasta, hmm = tmp / "headline.fsa", str(PROFILES / "1400.hmm")
    base = ["scan", "--stage", "search", "--align", "--hmm", hmm, "--fasta", str(fasta),
            "--device", DEVICE, "--format", "json"]
    out, msa = tmp / "align.json", tmp / "align.sto"
    got, e2e, secs, records = run_cli([*base, "--msa-out", str(msa), "--out", str(out)])
    for name in ("msv_scan", "viterbi_lazy_scan", "forward_prob_scan"):
        require(got[name] > 0, f"scan --align did not launch {name}")
    rows = alignment_rows(out)
    n_aln = 0
    for row in planted.tolist():
        r = rows.get(f"seq{row}")
        require(r is not None and r["hit"], f"planted row {row}: not a hit")
        spans = [(a["seq_from"], a["seq_to"]) for a in r["alignments"]]
        require(any(1 <= f <= t <= int(lengths[row]) for f, t in spans),
                f"planted row {row}: no alignment inside 1-{lengths[row]}: {spans}")
    n_aln = sum(len(r.get("alignments", [])) for r in rows.values())
    hits = sum(1 for r in rows.values() if r["hit"])
    names, msa_rows, rf = read_msa(msa)
    require(len(msa_rows) == n_aln and rf is not None,
            f"--msa-out: {len(msa_rows)} MSA rows for {n_aln} aligned domains")
    summary = next(r.getMessage() for r in records if r.getMessage().startswith("search "))
    print(f"scan --align: {summary}; {hits} hits, {n_aln} aligned domains, every planted row "
          f"aligned inside its sequence; --msa-out {len(msa_rows)} rows x {len(msa_rows[0])} "
          f"columns; launches {nonzero(got)}")
    print_seconds("scan --align (the traceback is the report phase)", secs, e2e)

    dom_out = tmp / "align_domains.json"
    got, e2e, secs, _ = run_cli([*base, "--domains", "--out", str(dom_out)])
    for name in ("forward_save_scan", "backward_coverage_scan"):
        require(got[name] > 0, f"scan --align --domains did not launch {name}")
    dom_rows = alignment_rows(dom_out)
    for row in planted.tolist():
        r = dom_rows[f"seq{row}"]
        require(r["ndom"] >= 1 and r["domains"] and r["alignments"],
                f"planted row {row}: --align --domains lost its domains or alignments")
    require([r.get("alignments") for r in dom_rows.values()]
            == [r.get("alignments") for r in rows.values()],
            "--align --domains: the alignments differ from --align's")
    print(f"scan --align --domains: every planted row keeps env_from/env_to/ndom/domains and "
          f"its alignments (equal to --align's); launches {nonzero(got)}")
    print_seconds("scan --align --domains", secs, e2e)

    stream_out, stream_msa = tmp / "align_stream.json", tmp / "align_stream.sto"
    got, e2e, secs, messages = run_cli_logged([*base, "--stream", str(STREAM_BATCH),
                                               "--msa-out", str(stream_msa),
                                               "--out", str(stream_out)])
    require(stream_out.read_bytes() == out.read_bytes(),
            "scan --align --stream: the report differs from the whole-file one")
    require(stream_msa.read_bytes() == msa.read_bytes(),
            "scan --align --stream: the MSA differs from the whole-file one")
    print(f"scan --align --stream {STREAM_BATCH}: report and MSA byte-equal to the whole-file "
          f"run; {side_stream(messages, BATCH // STREAM_BATCH, 'scan --align --stream')}; "
          f"launches {nonzero(got)}")
    print_seconds("scan --align --stream", secs, e2e)


def config_path(tmp: pathlib.Path, tokens, lengths) -> None:
    """`scan --stage search --config` with msv_p CONFIG_MSV_P: the survivor
    counts of SearchPipeline(msv_p=CONFIG_MSV_P) on the same batch staged
    by hand."""
    hmm_path = str(PROFILES / "1400.hmm")
    cfg = tmp / "engine.json"
    cfg.write_text(json.dumps({"msv_p": CONFIG_MSV_P}))
    got, e2e, secs, messages = run_cli_logged(
        ["scan", "--stage", "search", "--config", str(cfg), "--hmm", hmm_path, "--fasta",
         str(tmp / "headline.fsa"), "--device", DEVICE, "--out", str(tmp / "config.tsv")])
    line = next(m for m in messages if m.startswith("search "))
    n_msv, n_vit, n_hits = (int(x) for x in re.search(
        r"-> (\d+) past MSV -> (\d+) past Viterbi -> (\d+) hits", line).groups())
    scanner = MSVScanner(device=DEVICE)
    hmm = load_profile(hmm_path)
    want = SearchPipeline(scanner, msv_p=CONFIG_MSV_P).search(
        hmm, scanner.stage(tokens, lengths), tokens, lengths)
    want_counts = (int(want.passed_msv.sum()), int(want.passed_viterbi.sum()),
                   int(want.passed_forward.sum()))
    require((n_msv, n_vit, n_hits) == want_counts,
            f"--config msv_p {CONFIG_MSV_P}: {(n_msv, n_vit, n_hits)} survivors, "
            f"SearchPipeline gives {want_counts}")
    default = SearchPipeline(scanner).search(hmm, scanner.stage(tokens, lengths), tokens,
                                             lengths)
    print(f"scan --config (msv_p {CONFIG_MSV_P}): {line}; equal to SearchPipeline(msv_p="
          f"{CONFIG_MSV_P}) on the same batch; the default msv_p 0.02 passes "
          f"{int(default.passed_msv.sum())} past MSV")
    print_seconds("scan --config", secs, e2e)


def trace_path(tmp: pathlib.Path) -> None:
    """`scan --stage search --domains --profile-trace DIR`: the trace holds
    the kernels' device events under their symbol names; the device busy
    share of the labelled window (parse to report)."""
    trace_dir = tmp / "trace"
    got, e2e, secs, _ = run_cli(["scan", "--stage", "search", "--domains", "--hmm",
                                 str(PROFILES / "1400.hmm"), "--fasta",
                                 str(tmp / "headline.fsa"), "--device", DEVICE,
                                 "--profile-trace", str(trace_dir),
                                 "--out", str(tmp / "traced.tsv")])
    files = list(trace_dir.glob("*.pt.trace.json"))
    require(len(files) == 1, f"--profile-trace wrote {len(files)} trace files")
    trace = json.loads(files[0].read_text())
    kernels = profiling.kernel_events(trace)
    require(kernels, "--profile-trace: no CUDA kernel event in the trace (CUPTI recorded none)")
    names: dict = {}
    for k in kernels:
        key = re.sub(r"<.*", "", k["name"]).split("::")[-1].split("(")[0]
        n, us = names.get(key, (0, 0.0))
        names[key] = (n + 1, us + float(k.get("dur", 0)))
    for kernel in ("msv", "viterbi", "forward", "backward"):
        require(any(key.startswith(kernel) and key.endswith("_kernel") for key in names),
                f"--profile-trace: no {kernel} kernel event among {sorted(names)}")
    labels = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    require(labels >= set(profiling.PHASES), f"--profile-trace labels {sorted(labels)}")
    share, window = profiling.busy_share(trace)
    print(f"--profile-trace: {files[0].name}, {files[0].stat().st_size} bytes, "
          f"{len(kernels)} kernel events (launches counted {sum(got.values())}), labels "
          f"{sorted(labels & set(profiling.PHASES))}")
    for key, (n, us) in sorted(names.items(), key=lambda kv: -kv[1][1]):
        print(f"  device events {key}: {n}, {us / 1e3:.3f} ms")
    print(f"--profile-trace: device busy share {share:.6f} of the {window / 1e6:.6f} s "
          f"window from the first phase label to the last")
    print_seconds("scan --stage search --domains --profile-trace", secs, e2e)


def host_commands(tmp: pathlib.Path) -> None:
    """`info`, `emit` and `generate`, once each."""
    out = tmp / "info.tsv"
    _, e2e, _, _ = run_cli(["info", "--hmm-dir", str(PROFILES), "--consensus",
                            "--out", str(out)])
    lines = out.read_text().splitlines()
    require(len(lines) == 25 and lines[0].endswith("\tconsensus"), "info: 24 rows expected")
    print(f"info --hmm-dir --consensus: {len(lines) - 1} profiles in {e2e:.3f} s")
    out = tmp / "emit.fsa"
    _, e2e, _, _ = run_cli(["emit", "--hmm", str(PROFILES / "1400.hmm"), "--count", "8",
                            "--seed", "1", "--out", str(out)])
    require(out.read_text().count(">") == 8, "emit: 8 records expected")
    print(f"emit --count 8: {out.stat().st_size} bytes in {e2e:.3f} s")
    out = tmp / "generated.fsa"
    _, e2e, _, _ = run_cli(["generate", "--count", "16", "--length", "3500", "--seed", "1",
                            "--out", str(out)])
    db = load_fasta(out, prefer="python")
    require(len(db) == 16 and all(len(r.sequence) == 3500 for r in db.records),
            "generate: 16 x 3500 expected")
    print(f"generate --count 16 --length 3500: {out.stat().st_size} bytes in {e2e:.3f} s")


def subcommand_paths(tmp: pathlib.Path) -> None:
    build_path(tmp)
    tokens, lengths = load_fasta(tmp / "headline.fsa").encode()
    align_paths(tmp, tokens, lengths, planted_rows())
    config_path(tmp, tokens, lengths)
    trace_path(tmp)
    host_commands(tmp)


# -- the fused cascade (phase 15) ----------------------------------------------

# the kernels of the fused cascade on 1400.hmm (e_skip_d holds: the lazy
# Viterbi), in the order it launches them
FUSED_KERNELS = ("msv_filter_scan", "msv_scan", "viterbi_filter_scan", "viterbi_lazy_scan",
                 "forward_prob_scan")
# a stage scan of the scanner -> the kernel it launches there
STAGE_KERNELS = {"scan_filter": "B2", "scan": "B1", "scan_p7_filter": "B6",
                 "viterbi": "B7", "forward": "B5"}


class StageEvents:
    """CUDA events around each stage scan a search makes (the scanner's
    ``scan_filter``, ``scan``, ``scan_p7_filter`` and ``scan_p7``, wrapped
    on the instance while entered): each stage's ms, and the span from the
    first stage's start to the last one's end; and the host's seconds in
    each stage's call (``host``)."""

    def __init__(self, scanner):
        self.scanner = scanner
        self.marks: list = []
        self.host = dict.fromkeys(STAGE_KERNELS.values(), 0.0)

    def __enter__(self):
        for name in ("scan_filter", "scan", "scan_p7_filter", "scan_p7"):
            setattr(self.scanner, name, self._timed(name, getattr(self.scanner, name)))
        return self

    def __exit__(self, *exc):
        for name in ("scan_filter", "scan", "scan_p7_filter", "scan_p7"):
            delattr(self.scanner, name)

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stage = kwargs.get("stage", "viterbi") if name == "scan_p7" else name
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.host[STAGE_KERNELS[stage]] += time.perf_counter() - t0
            self.marks.append((stage, start, end))
            return out
        return run

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = dict.fromkeys(STAGE_KERNELS.values(), 0.0)
        for stage, start, end in self.marks:
            out[STAGE_KERNELS[stage]] += start.elapsed_time(end)
        out["span"] = self.marks[0][1].elapsed_time(self.marks[-1][2])
        return out


def time_search(pipeline, hmm, staged, tokens, lengths):
    """Best of 3 after a warm-up: the host clock around ``pipeline.search``
    (its read-backs included) and, per stage, the CUDA events of
    :class:`StageEvents`. Returns (seconds, {stage: ms}, the last result)."""
    pipeline.search(hmm, staged, tokens, lengths)
    best_s, best_ms = float("inf"), {}
    for _ in range(3):
        torch.cuda.synchronize()
        with StageEvents(pipeline.scanner) as events:
            t0 = time.perf_counter()
            result = pipeline.search(hmm, staged, tokens, lengths)
            best_s = min(best_s, time.perf_counter() - t0)
        for k, v in events.ms().items():
            best_ms[k] = min(best_ms.get(k, float("inf")), v)
    return best_s, best_ms, result


def same_results(a, b) -> bool:
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name), equal_nan=True)
               for f in dataclasses.fields(a))


def fused_cli(tmp: pathlib.Path) -> None:
    """`scan --stage search --fused` and its compositions on phase 9's
    database and reports."""
    fasta, hmm = tmp / "headline.fsa", str(PROFILES / "1400.hmm")
    common = ["scan", "--stage", "search", "--fused", "--hmm", hmm, "--fasta", str(fasta),
              "--device", DEVICE]
    out = tmp / "search_fused.tsv"
    got, e2e, secs, messages = run_cli_logged([*common, "--out", str(out)])
    require(nonzero(got) == dict.fromkeys(FUSED_KERNELS, 1),
            f"--fused launched {nonzero(got)}, expected each of {FUSED_KERNELS} once")
    line = next(m for m in messages if m.startswith("search "))
    require(" (fused): " in line, f"--fused did not run the fused cascade: {line}")
    require(out.read_bytes() == (tmp / "search_fast.tsv").read_bytes(),
            "the --fused report differs from phase 9's --fast report")
    require(set(hit_rows(out)) == set(hit_rows(tmp / "search.tsv")),
            "the --fused hits differ from phase 9's search's")
    print(f"fused search: {line}; report byte-equal to --fast's, hits the search's; "
          f"launches {nonzero(got)}")
    print_seconds("fused search", secs, e2e)

    dom = tmp / "domains_fused.tsv"
    got, e2e, secs, _ = run_cli_logged([*common, "--domains", "--out", str(dom)])
    hits = hit_rows(dom)
    require(hits == hit_rows(tmp / "domains.tsv"),
            "the --fused --domains hit rows differ from phase 9's --domains report's")
    for row in planted_rows().tolist():
        r = hits.get(f"seq{row}")
        require(r is not None, f"--fused --domains: planted row {row} not a hit")
        env_from, env_to, ndom = (int(x) for x in r.split("\t")[8:11])
        require(ndom >= 1 and 1 <= env_from <= env_to <= SEQ_LEN,
                f"--fused --domains: planted row {row} envelope {env_from}-{env_to} x{ndom}")
    print(f"fused search --domains: {len(hits)} hit rows equal to phase 9's --domains "
          f"report's, every planted row a hit with an envelope; launches {nonzero(got)}")
    print_seconds("fused search --domains", secs, e2e)

    streamed = tmp / "search_fused_stream.tsv"
    got, e2e, secs, messages = run_cli_logged(
        [*common, "--stream", str(STREAM_BATCH), "--out", str(streamed)])
    batches = -(-BATCH // STREAM_BATCH)
    require(streamed.read_bytes() == out.read_bytes(),
            "--fused --stream: the report differs from the whole-file --fused one")
    line = next(m for m in messages if m.startswith("streamed search ") and "past MSV" in m)
    require(line.endswith(f", the fused cascade on {batches} batches"),
            f"--fused --stream: {line}")
    require(nonzero(got) == dict.fromkeys(FUSED_KERNELS, batches),
            f"--fused --stream launched {nonzero(got)}")
    print(f"fused search --stream {STREAM_BATCH}: byte-equal to the whole-file --fused "
          f"report; {line}; launches {nonzero(got)}")
    print_seconds("fused search --stream", secs, e2e)

    zero_launches()
    rc = cli.main([*common, "--bucketed", "--out", str(tmp / "refused.tsv")])
    require(rc == 2 and not nonzero(launches()), f"--fused --bucketed exited {rc}")
    print("fused search --bucketed: exit 2, nothing launched")


def fused_library(tmp: pathlib.Path, scanner) -> None:
    """The capacity overflow, the sync check and the timings of
    SearchPipeline(fused=True) on phase 9's database."""
    hmm = load_profile(PROFILES / "1400.hmm")
    consensus = np.argmax(hmm.match_emissions[1:], axis=1)
    tokens = np.tile(consensus, (FUSED_OVERFLOW, 1)).astype(np.int32)
    lengths = np.full(FUSED_OVERFLOW, len(consensus), dtype=np.int32)
    staged = scanner.stage(tokens, lengths)
    handler = _Records()
    package = logging.getLogger("hmm_fasta_viterbi_tpu_torch")
    package.addHandler(handler)
    pipeline = SearchPipeline(scanner, fused=True)
    try:
        got = pipeline.search(hmm, staged, tokens, lengths)
    finally:
        package.removeHandler(handler)
    line = next((r.getMessage() for r in handler.records
                 if "capacity overflow" in r.getMessage()), None)
    require(line is not None and pipeline.fused_runs == 0,
            f"{FUSED_OVERFLOW} consensus copies: no capacity overflow logged")
    require(same_results(got, SearchPipeline(scanner).search(hmm, staged, tokens, lengths)),
            "the overflow's result differs from the staged cascade's")
    print(f"fused overflow ({FUSED_OVERFLOW} consensus copies, caps "
          f"{fused_caps(FUSED_OVERFLOW, pipeline.msv_p)}): {line}; the staged result, "
          f"{got.hits.size} hits")

    tokens, lengths = load_fasta(tmp / "headline.fsa").encode()
    staged = scanner.stage(tokens, lengths)
    fused = SearchPipeline(scanner, fused=True)
    result = fused.search(hmm, staged, tokens, lengths)  # warm: packs and thresholds cached
    msv_profile, p7 = fused._derived(hmm)
    thresholds, caps = fused._fused_thresholds(hmm), fused_caps(len(lengths), fused.msv_p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with StageEvents(scanner) as events:
            t0 = time.perf_counter()
            out = fused_cascade(scanner, msv_profile, p7, staged, thresholds, caps)
            enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = {k: int(out[k]) for k in ("n1", "n2", "n3")}
    require(counts["n2"] == int(result.passed_msv.sum()) >= PLANTED,
            f"fused survivors {counts} against {int(result.passed_msv.sum())} past MSV")
    stages = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in events.host.items())
    print(f"fused chain enqueued under set_sync_debug_mode('error'): no host sync; enqueue "
          f"{enqueue_s * 1e3:.3f} ms on the host (in the stage calls, ms: {stages}; the "
          f"compactions the rest); device span {events.ms()['span']:.3f} ms; survivors "
          f"{counts}, caps {caps}")

    fast = SearchPipeline(scanner, fast_msv=True, fast_viterbi=True)
    fused_s, fused_ms, fused_result = time_search(fused, hmm, staged, tokens, lengths)
    fast_s, fast_ms, fast_result = time_search(fast, hmm, staged, tokens, lengths)
    require(fused.fused_runs == 5, f"the fused search ran fused {fused.fused_runs} of 5 times")
    require(same_results(fused_result, fast_result),
            "the fused search's result differs from the fast search's")
    card = nvidia_smi("name,power.limit")
    for label, sec, ms in (("fused", fused_s, fused_ms), ("--fast", fast_s, fast_ms)):
        stages = ", ".join(f"{k} {v:.3f}" for k, v in ms.items() if k != "span")
        print(f"search timing {label} ({card}; {BATCH} x {SEQ_LEN} vs 1400.hmm, best of 3): "
              f"host {sec * 1e3:.3f} ms around search; stage kernels ms: {stages}; first stage "
              f"start to last stage end {ms['span']:.3f} ms")
    print(f"search timing: fused/--fast host {fused_s / fast_s:.3f}; results equal field for "
          f"field; {int(fast_result.passed_msv.sum())} past MSV, "
          f"{int(fast_result.passed_viterbi.sum())} past Viterbi, {fast_result.hits.size} hits")


# -- the device mesh (phase 13) -----------------------------------------------

def mesh_of(db: int, sp: int = 1):
    """A (db, sp) mesh over one card named db * sp times."""
    return make_scan_mesh(db=db, sp=sp, devices=[torch.device(DEVICE)] * (db * sp))


def require_same_scores(got, want, what: str) -> float:
    """Two score vectors (tensors or host arrays) equal bit for bit."""
    got, want = (torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x))
                 for x in (got, want))
    return require_equal([got], [want], what)


def db_mesh_stages(tokens, lengths, scanner, errors: dict) -> None:
    """Every stage of MSVScanner(mesh=) on a db = MESH_DB mesh of one card,
    against the single-device scanner bit for bit, launch counts zeroed
    just before the mesh's run and read just after: B1, B2 and B3 (the 24
    profiles) on the whole database, B7, B4 (1400.hmm without e_skip_d), B5
    and B6 on its first STAGE_BATCH rows, B9 and B10 (the posterior decode
    of POST_TIME_BATCH rows of POST_TIME_LEN residues); top_k_hits against
    torch.topk of the single scanner's scores."""
    mesh = mesh_of(MESH_DB)
    msc = MSVScanner(mesh=mesh)
    prof, p7 = profile("1400"), p7_profile("1400")
    eager = without_e_skip_d(p7, "tdd")
    profs = [profile(stem) for stem in stems()]
    sub = slice(0, STAGE_BATCH)
    post = (tokens[:POST_TIME_BATCH, :POST_TIME_LEN],
            np.minimum(lengths[:POST_TIME_BATCH], POST_TIME_LEN))
    stages = {
        "msv_scan": (lambda sc, st, st7: sc.scan(prof, st), "full"),
        "msv_filter_scan": (lambda sc, st, st7: sc.scan_filter(prof, st), "full"),
        "msv_stacked_scan": (lambda sc, st, st7: sc.scan_many(profs, st), "full"),
        "viterbi_lazy_scan": (lambda sc, st, st7: sc.scan_p7(p7, st7, "viterbi"), "stage"),
        "viterbi_scan": (lambda sc, st, st7: sc.scan_p7(eager, st7, "viterbi"), "stage"),
        "forward_prob_scan": (lambda sc, st, st7: sc.scan_p7(p7, st7, "forward"), "stage"),
        "viterbi_filter_scan": (lambda sc, st, st7: sc.scan_p7_filter(p7, st7), "stage"),
    }
    staged = {"mesh": (msc.stage(tokens, lengths), msc.stage(tokens[sub], lengths[sub])),
              "one": (scanner.stage(tokens, lengths), scanner.stage(tokens[sub], lengths[sub]))}
    print(f"db mesh: {mesh.shape} over {[str(d) for row in mesh.devices for d in row]}; "
          f"{len(staged['mesh'][0].shards)} shards of "
          f"{[r.stop - r.start for r in staged['mesh'][0].rows]} rows")
    for name, (scan, rows) in stages.items():
        torch.cuda.synchronize()
        zero_launches()
        got = scan(msc, *staged["mesh"])
        torch.cuda.synchronize()
        counts = launches()
        want = scan(scanner, *staged["one"])
        require(counts[name] >= MESH_DB, f"db mesh {name}: {counts[name]} launches for "
                                         f"{MESH_DB} shards")
        if isinstance(got, dict):
            err = max(require_same_scores(got[p.name], want[p.name], f"db mesh {name} {p.name}")
                      for p in profs)
        else:
            err = require_same_scores(got, want, f"db mesh {name}")
        errors[name] = max(errors[name], err)
        n = BATCH if rows == "full" else STAGE_BATCH
        print(f"db mesh {name}: {n} x {SEQ_LEN} == the single-device scanner (max|d|={err}); "
              f"launches {nonzero(counts)}")
    zero_launches()
    cov, tot = posterior_cuda.posterior_coverage_batch(p7, *post, mesh=mesh)
    counts = launches()
    cov1, tot1 = posterior_cuda.posterior_coverage_batch(p7, *post, device=DEVICE)
    for name in ("forward_save_scan", "backward_coverage_scan"):
        require(counts[name] >= MESH_DB, f"db mesh posterior: {counts[name]} {name} launches")
    err = max(require_same_scores(tot, tot1, "db mesh posterior totals"),
              require_equal([torch.from_numpy(cov)], [torch.from_numpy(cov1)],
                            "db mesh posterior coverage"))
    errors["backward_coverage_scan"] = max(errors["backward_coverage_scan"], err)
    print(f"db mesh posterior_coverage_batch(mesh=): {POST_TIME_BATCH} x {POST_TIME_LEN} == "
          f"the single device (coverage and totals, max|d|={err}); launches {nonzero(counts)}")
    scores = msc.scan(prof, staged["mesh"][0])
    vals, idx = top_k_hits(scores, PLANTED)
    want_vals, want_idx = torch.topk(scanner.scan(prof, staged["one"][0]), PLANTED)
    require(torch.equal(vals.cpu(), want_vals.cpu()) and torch.equal(idx.cpu(), want_idx.cpu()),
            "top_k_hits of the mesh's scores != torch.topk of the single device's")
    print(f"top_k_hits(k={PLANTED}) on the mesh's scores == torch.topk of the single scanner's")


def sp_wavefront(scanner, errors: dict) -> None:
    """The sp wavefront on the length-skewed database (phase 11's), on a
    db = 1, sp = MESH_SP mesh and a db = 2, sp = MESH_SP one of one card,
    against the single-device scanner, launch counts zeroed just before
    each wavefront and read just after: MSV (B1), Viterbi (B7, and B4
    without e_skip_d; db = 1) bit for bit, Forward (B5; db = 1) bit for
    bit and within FWD_TOL; SeqblockScanner under SearchPipeline gives the
    single-device search's result field for field, every one of PLANTED
    homologs of 1400.hmm planted in the database a hit."""
    tokens, lengths = skewed_batch()
    hmm = parse_hmm(PROFILES / "1400.hmm")
    planted = np.arange(PLANTED) * (len(lengths) // PLANTED) + 7
    for row, seq in zip(planted, sample_sequences(hmm, PLANTED, seed=SEED + 13)):
        seq = seq[: tokens.shape[1]]
        tokens[row, : len(seq)] = seq
        lengths[row] = len(seq)
    staged = scanner.stage(tokens, lengths)
    prof, p7 = profile("1400"), p7_profile("1400")
    eager = without_e_skip_d(p7, "tdd")
    one = {"msv_scan": scanner.scan(prof, staged),
           "viterbi_lazy_scan": scanner.scan_p7(p7, staged, "viterbi"),
           "viterbi_scan": scanner.scan_p7(eager, staged, "viterbi"),
           "forward_prob_scan": scanner.scan_p7(p7, staged, "forward")}
    want = SearchPipeline(scanner).search(hmm, staged, tokens, lengths)
    runs = {"msv_scan": lambda mesh: msv_scan_seqblocks(prof, tokens, lengths, mesh),
            "viterbi_lazy_scan": lambda mesh: p7_scan_seqblocks(p7, tokens, lengths, mesh),
            "viterbi_scan": lambda mesh: p7_scan_seqblocks(eager, tokens, lengths, mesh),
            "forward_prob_scan": lambda mesh: p7_scan_seqblocks(p7, tokens, lengths, mesh,
                                                                "forward")}
    blk = block_length(tokens.shape[1], MESH_SP)
    print(f"sp wavefront: the skewed database, {len(lengths)} rows up to {tokens.shape[1]} "
          f"residues, {PLANTED} homologs of 1400.hmm planted; blocks of {blk} residues (a "
          f"multiple of FWD_RESCALE_GROUP {p7_cuda.FWD_RESCALE_GROUP})")
    for db in (1, 2):
        mesh = mesh_of(db, MESH_SP)
        # db = 2 repeats the MSV wavefront; its search runs the p7 ones
        for name, run in (runs.items() if db == 1 else [("msv_scan", runs["msv_scan"])]):
            torch.cuda.synchronize()
            zero_launches()
            got = run(mesh)
            counts = launches()
            require(counts[name] >= MESH_SP, f"sp wavefront {name}: {counts[name]} launches")
            err = max_abs_diff(torch.from_numpy(got), one[name].cpu())
            if name == "forward_prob_scan":
                require(err <= FWD_TOL, f"sp wavefront Forward: max |d| {err} > {FWD_TOL}")
            require_same_scores(got, one[name], f"sp wavefront {name} db={db}")
            errors[name] = max(errors[name], err)
            print(f"sp wavefront {name} {mesh.shape}: == one call (max|d|={err}); launches "
                  f"{nonzero(counts)}")
        sb = SeqblockScanner(mesh)
        zero_launches()
        got = SearchPipeline(sb).search(hmm, sb.stage(tokens, lengths), tokens, lengths)
        counts = launches()
        for field in ("msv_scores", "viterbi_scores", "forward_scores", "passed_msv",
                      "passed_viterbi", "passed_forward"):
            require(np.array_equal(getattr(got, field), getattr(want, field), equal_nan=True),
                    f"sp search {mesh.shape}: {field} differs from the single device's")
        missed = sorted(set(planted.tolist()) - set(got.hits.tolist()))
        require(not missed, f"sp search {mesh.shape}: planted rows not hits: {missed}")
        print(f"sp search {mesh.shape}: {int(got.passed_msv.sum())} past MSV, "
              f"{int(got.passed_viterbi.sum())} past Viterbi, {int(got.passed_forward.sum())} "
              f"hits, the single device's result field for field; launches {nonzero(counts)}")


def mesh_cli(tmp: pathlib.Path) -> None:
    """The CLI with --mesh on phase 9's database, each report byte-equal to
    its meshless report of phase 9 (or 11), launch counts zeroed around
    each run: `scan --mesh db=1`, `--mesh all`, `--config` with use_mesh
    (mesh_db 1, the search), `scan --stage search --domains --mesh db=1`,
    `sweep --mesh db=1`, `scan --stream 4096 --mesh db=1`; `--mesh db=2`
    exits 2 on one card and is byte-equal on two or more."""
    fasta, hmm = str(tmp / "headline.fsa"), str(PROFILES / "1400.hmm")
    cfg = tmp / "mesh_engine.json"
    cfg.write_text(json.dumps({"use_mesh": True, "mesh_db": 1}))
    runs = [
        ("scan --mesh db=1", ["scan", "--hmm", hmm, "--mesh", "db=1"], "scan.tsv"),
        ("scan --mesh all", ["scan", "--hmm", hmm, "--mesh", "all"], "scan.tsv"),
        ("scan --stage search --config use_mesh",
         ["scan", "--stage", "search", "--hmm", hmm, "--config", str(cfg)], "search.tsv"),
        ("scan --stage search --domains --mesh db=1",
         ["scan", "--stage", "search", "--domains", "--hmm", hmm, "--mesh", "db=1"],
         "domains.tsv"),
        ("sweep --mesh db=1", ["sweep", "--hmm-dir", str(PROFILES), "--mesh", "db=1"],
         "sweep.tsv"),
        ("scan --stream 4096 --mesh db=1",
         ["scan", "--hmm", hmm, "--stream", str(STREAM_BATCH), "--mesh", "db=1"], "scan.tsv"),
    ]
    if torch.cuda.device_count() >= 2:
        runs.append(("scan --mesh db=2", ["scan", "--hmm", hmm, "--mesh", "db=2"], "scan.tsv"))
    for label, argv, phase9 in runs:
        out = tmp / "mesh_cli.tsv"
        got, e2e, secs, messages = run_cli_logged([*argv, "--fasta", fasta, "--device", DEVICE,
                                                   "--out", str(out)])
        require(out.read_bytes() == (tmp / phase9).read_bytes(),
                f"{label}: the report differs from the meshless {phase9}")
        mesh_line = next((m for m in messages if m.startswith("mesh: ")), None)
        require(mesh_line is not None, f"{label}: no mesh line")
        print(f"CLI {label}: report byte-equal to the meshless {phase9}; {mesh_line}; "
              f"launches {nonzero(got)}; end to end {e2e:.3f} s")
        if secs is not None:
            print_seconds(f"  {label}", secs, e2e)
    if torch.cuda.device_count() < 2:
        rc = cli.main(["scan", "--hmm", hmm, "--fasta", fasta, "--device", DEVICE, "--mesh",
                       "db=2", "--out", str(tmp / "mesh_cli.tsv")])
        require(rc == 2, f"scan --mesh db=2 on one card exited {rc}, expected 2")
        print("CLI scan --mesh db=2 on one card: exit 2 (the mesh needs more cards than "
              "are visible)")


def mesh_timings(tokens, lengths, scanner) -> None:
    """Best of 3 by CUDA events: the db = MESH_DB one-card mesh against the
    single scanner for B1 on the whole database and for the --domains
    search (the cascade and the decode of its hits); the sp = MESH_SP
    wavefront against one call of B1, B7 and B5 on the skewed database,
    launches counted over one run."""
    mesh = mesh_of(MESH_DB)
    msc = MSVScanner(mesh=mesh)
    prof, p7 = profile("1400"), p7_profile("1400")
    hmm = parse_hmm(PROFILES / "1400.hmm")
    staged_m, staged_1 = msc.stage(tokens, lengths), scanner.stage(tokens, lengths)

    def domains_search(sc, staged, where):
        res = SearchPipeline(sc).search(hmm, staged, tokens, lengths)
        hits = res.hits
        l_max = max(int(lengths[hits].max()), 1) if hits.size else 1
        posterior_cuda.posterior_coverage_batch(p7, tokens[hits, :l_max], lengths[hits],
                                                mask_threshold=0.5, **where)

    card = nvidia_smi("name,power.limit")
    for label, mesh_fn, one_fn in (
        ("B1 scan", lambda: msc.scan(prof, staged_m), lambda: scanner.scan(prof, staged_1)),
        ("--domains search", lambda: domains_search(msc, staged_m, {"mesh": mesh}),
         lambda: domains_search(scanner, staged_1, {"device": DEVICE})),
    ):
        one_ms, mesh_ms = best_ms(one_fn, 3), best_ms(mesh_fn, 3)
        zero_launches()
        mesh_fn()
        torch.cuda.synchronize()
        counts = nonzero(launches())
        print(f"mesh timing {label} {BATCH} x {SEQ_LEN} x 1400.hmm: single scanner "
              f"{one_ms:.3f} ms, db={MESH_DB} one-card mesh {mesh_ms:.3f} ms "
              f"({mesh_ms - one_ms:+.3f} ms), mesh launches {counts} [{card}]")
    tokens_s, lengths_s = skewed_batch()
    staged_s = scanner.stage(tokens_s, lengths_s)
    sp_mesh = mesh_of(1, MESH_SP)
    for name, one_fn, sp_fn in (
        ("msv_scan", lambda: scanner.scan(prof, staged_s),
         lambda: msv_scan_seqblocks(prof, tokens_s, lengths_s, sp_mesh)),
        ("viterbi_lazy_scan", lambda: scanner.scan_p7(p7, staged_s, "viterbi"),
         lambda: p7_scan_seqblocks(p7, tokens_s, lengths_s, sp_mesh)),
        ("forward_prob_scan", lambda: scanner.scan_p7(p7, staged_s, "forward"),
         lambda: p7_scan_seqblocks(p7, tokens_s, lengths_s, sp_mesh, "forward")),
    ):
        one_ms, sp_ms = best_ms(one_fn, 3), best_ms(sp_fn, 3)
        zero_launches()
        sp_fn()
        n = launches()[name]
        print(f"mesh timing {name} on the skewed database: one call {one_ms:.3f} ms; sp="
              f"{MESH_SP} wavefront {sp_ms:.3f} ms (host staging and the block copies "
              f"included), {n} launches [{card}]")


def mesh_paths(tmp: pathlib.Path, scanner, errors: dict) -> None:
    print(f"cards: {torch.cuda.device_count()}; {nvidia_smi('name,power.limit')}")
    tokens, lengths = load_fasta(tmp / "headline.fsa").encode(dtype=np.int8)
    db_mesh_stages(tokens, lengths, scanner, errors)
    sp_wavefront(scanner, errors)
    mesh_cli(tmp)
    t0 = time.perf_counter()
    dryrun_multichip(8, device=DEVICE)
    print(f"dryrun_multichip(8) over {DEVICE} x 8: ok in {time.perf_counter() - t0:.2f} s")
    mesh_timings(tokens, lengths, scanner)


# -- fuzzed profiles (phase 14) -----------------------------------------------

def fuzz_kernels_vs_plain(scanner, errors: dict) -> None:
    """FUZZ_SEEDS profiles of tests/test_fuzz_differential.py's generator
    (models/fuzz.py: spiky emissions, a quarter of the nodes delete-heavy)
    through every kernel against its plain version on a ragged batch: B1,
    B2 (>= B1) and B4 equal; B7 equal to B4, and at lazy_k = 1 (its
    certificate fires, chunks replay) equal to its plain version; B5 within
    FWD_TOL; B6 equal and >= B4; B8 within LOG_FWD_TOL; B9 equal to B5;
    B10 and the totals within COV_TOL / TOT_TOL; B4 and B6 again without
    e_skip_d; B3 over all of them equal to B1 and B2."""
    rng = np.random.default_rng(SEED + 14)
    lengths = rng.integers(0, FUZZ_LEN + 1, size=FUZZ_BATCH).astype(np.int32)
    lengths[:8] = [0, 1, 31, 32, 33, 128, 257, FUZZ_LEN]
    tokens = rng.integers(0, 20, size=(FUZZ_BATCH, FUZZ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, lengths)
    profs = []
    for seed, top in FUZZ_SEEDS:
        gen = np.random.default_rng(seed)
        # named by seed: two seeds may draw one LENG, and a sweep keys by name
        hmm = dataclasses.replace(random_profile(gen, int(gen.integers(3, top))),
                                  name=f"fuzz{seed}")
        prof, p7 = MSVProfile.from_profile(hmm), P7Profile.from_profile(hmm)
        profs.append(prof)
        err, exact = msv_compare(msv_args(scanner, prof, staged))
        f_err, filt = msv_compare(msv_args(scanner, prof, staged, filter_mode=True), True)
        require_geq(filt, exact, f"fuzz {seed} MSV filter vs MSV")
        packs = p7_packs(p7, scanner.device)
        run_e, carry_v = p7_calls("eager", packs["eager"], staged)
        eager = run_e(p7_cuda.viterbi_scan_cuda, staged.tokens, staged.lengths, carry_v)
        torch.cuda.synchronize()
        e_err = require_equal(eager, run_e(p7_cuda.viterbi_scan_plain, staged.tokens,
                                           staged.lengths, carry_v), f"fuzz {seed} eager")
        replays = (0, 0)
        if p7_cuda.e_skip_d_ok(p7):
            run_l, _ = p7_calls("lazy", packs["lazy"], staged)
            lazy = run_l(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_v)
            require_equal(lazy[:5], (*eager[:3], pre_diag(packs["eager"], *eager[1:4]), eager[4]),
                          f"fuzz {seed} lazy vs eager")
            # a window of one pass: the certificate fires and chunks replay
            k1 = p7_cuda.viterbi_pack(p7, scanner.device, lazy=True, lazy_k=1)
            run_k, _ = p7_calls("lazy", k1, staged)
            got_k = run_k(p7_cuda.viterbi_lazy_scan_cuda, staged.tokens, staged.lengths, carry_v)
            torch.cuda.synchronize()
            require_equal(got_k, run_k(p7_cuda.viterbi_lazy_scan_plain, staged.tokens,
                                       staged.lengths, carry_v),
                          f"fuzz {seed} lazy_k=1 vs plain (replays included)")
            require_equal([got_k[0]], [eager[0]], f"fuzz {seed} lazy_k=1 vs eager")
            replays = (int(lazy[5].sum()), int(got_k[5].sum()))
        run_f, carry_f = p7_calls("forward", packs["forward"], staged)
        fwd = run_f(p7_cuda.forward_prob_scan_cuda, staged.tokens, staged.lengths, carry_f)
        saved = run_f(posterior_cuda.forward_save_scan_cuda, staged.tokens, staged.lengths,
                      carry_f)
        torch.cuda.synchronize()
        fw_err = max_abs_diff(fwd[0], run_f(p7_cuda.forward_prob_scan_plain, staged.tokens,
                                            staged.lengths, carry_f)[0])
        require(fw_err <= FWD_TOL, f"fuzz {seed} Forward vs plain: {fw_err}")
        s_err = require_equal(saved[:5], fwd, f"fuzz {seed} row-saving Forward vs Forward")
        vf_err, window = filter_vs_plain(p7, staged, eager[0])
        run_g, carry_g = p7_calls("log", packs["log"], staged)
        log = run_g(p7_cuda.forward_log_scan_cuda, staged.tokens, staged.lengths, carry_g)
        torch.cuda.synchronize()
        l_err = max_abs_diff(log[0], run_g(p7_cuda.forward_log_scan_plain, staged.tokens,
                                           staged.lengths, carry_g)[0])
        require(l_err <= LOG_FWD_TOL, f"fuzz {seed} log-space Forward vs plain: {l_err}")
        schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
        cov, tot = posterior_decode(*KERNEL_DECODE, packs["forward"], schain, staged)
        torch.cuda.synchronize()
        cov_p, tot_p = posterior_decode(*PLAIN_DECODE, packs["forward"], schain, staged)
        c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(tot, tot_p)
        require(c_err <= COV_TOL and t_err <= TOT_TOL,
                f"fuzz {seed} posterior vs plain: coverage {c_err}, totals {t_err}")
        bad = without_e_skip_d(p7, "tdd")
        bad_pack = p7_cuda.viterbi_pack(bad, scanner.device, lazy=False)
        run_b, carry_b = p7_calls("eager", bad_pack, staged)
        bad_eager = run_b(p7_cuda.viterbi_scan_cuda, staged.tokens, staged.lengths, carry_b)
        torch.cuda.synchronize()
        b_err = require_equal(bad_eager, run_b(p7_cuda.viterbi_scan_plain, staged.tokens,
                                               staged.lengths, carry_b),
                              f"fuzz {seed} eager without e_skip_d")
        bf_err, bad_window = filter_vs_plain(bad, staged, bad_eager[0])
        for name, e in (("msv_scan", err), ("msv_filter_scan", f_err),
                        ("viterbi_scan", max(e_err, b_err)), ("forward_prob_scan", fw_err),
                        ("viterbi_filter_scan", max(vf_err, bf_err)), ("forward_log_scan", l_err),
                        ("forward_save_scan", max(s_err, t_err)),
                        ("backward_coverage_scan", c_err)):
            errors[name] = max(errors[name], e)
        print(f"fuzz seed {seed} (LENG {hmm.model_length - 1}, e_skip_d "
              f"{p7_cuda.e_skip_d_ok(p7)}): B={FUZZ_BATCH} L<={FUZZ_LEN} MSV max|d|={err}, "
              f"filter {f_err}; eager {e_err}, lazy == eager ({replays[0]} chunks replayed; at "
              f"lazy_k = 1 {replays[1]}); "
              f"Forward {fw_err:.3g}, row-saving == Forward; filter(window {window}) {vf_err}; "
              f"log Forward {l_err:.3g}; coverage {c_err:.3g}, totals {t_err:.3g}; without "
              f"e_skip_d: eager {b_err}, filter(window {bad_window}) {bf_err}", flush=True)
    for mode, single in (("exact", scanner.scan), ("filter", scanner.scan_filter)):
        res = scanner.scan_many(profs, staged, mode=mode)
        err = max(require_same_scores(res[p.name], single(p, staged),
                                      f"fuzz stacked {mode} {p.name}") for p in profs)
        errors["msv_stacked_scan"] = max(errors["msv_stacked_scan"], err)
        print(f"fuzz stacked MSV ({mode}): {len(profs)} profiles == their single kernels "
              f"(max|d|={err})")


# -- the bench (phase 16) -----------------------------------------------------

# the kernels the bench's rows launch (B1, B2, B3, B5, B6, B7, B9, B10; B4 and
# B8 are on no bench.py row)
BENCH_KERNELS = ("msv_scan", "msv_filter_scan", "msv_stacked_scan", "forward_prob_scan",
                 "viterbi_filter_scan", "viterbi_lazy_scan", "forward_save_scan",
                 "backward_coverage_scan")


def bench_row_names() -> list[str]:
    """bench.py's rows in its order under ``_cuda`` (``e2e_1400`` with
    ``--e2e``; oracle_msv_numpy keeps its name)."""
    names = ["sweep24"] + [f"sweep_p{profile(stem).num_states}" for stem in stems()]
    names += ["sweep24_filter", "filter_1400", "headline_2405", "viterbi_1400", "forward_1400",
              "viterbi_filter_1400", "cascade_1400", "cascade_fast_1400", "posterior_1400",
              "posterior_mask_1400", "stream_search_1400"]
    return [f"{n}_cuda" for n in names] + ["oracle_msv_numpy", "ref_1400_b3_cuda",
                                           "e2e_1400_cuda"]


def bench_rows(tmp: pathlib.Path, rng, b1_ms: float) -> None:
    """`msv_scores` (the one-call MSV entry) on the card against the oracle
    and its plain version; then the bench's main in-process at its defaults
    with --e2e, every launch count set to 0 just before it and read just
    after: no error, every bench.py row under `_cuda`, each row kernel
    launched; its JSON line, each row's GCUPS and ms, and the headline's
    wall-clock ms against phase 10's CUDA-event ms for B1 at the same
    shape."""
    lengths8 = np.minimum([0, 1, 31, 32, 33, 257, 1000, SEQ_LEN], SEQ_LEN).astype(np.int32)
    tokens8 = rng.integers(0, 20, size=(8, SEQ_LEN)).astype(np.int32)
    for stem in ("1400", "2405"):
        prof = profile(stem)
        got = msv_scores(prof, tokens8, lengths8, device=DEVICE)
        require(got.device.type == "cuda", "msv_scores did not score on the card")
        got = got.cpu()
        plain = msv_scores(prof, tokens8, lengths8, device="cpu")
        err = require_equal([got], [plain], f"msv_scores on the card vs its plain version, "
                                            f"{stem}.hmm")
        require(np.array_equal(got.numpy(), msv_oracle_batch(prof, tokens8, lengths8)),
                f"msv_scores on the card != oracle on {stem}.hmm")
        print(f"msv_scores {stem}.hmm: 8 ragged seqs, == plain (max|d|={err}) == oracle")

    detail = tmp / "bench_detail_torch.json"
    out = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench_main(["--e2e", "--detail-file", str(detail)])
    seconds = time.perf_counter() - t0
    counts = launches()
    require(rc == 0, f"the bench returned {rc}")
    line = out.getvalue().splitlines()[-1]
    payload = json.loads(line)
    require(payload["metric"] == "GCUPS_M1400" and payload["value"] > 0,
            f"the bench's headline: {payload['metric']} {payload['value']}")
    require(payload["errors"] == [], f"the bench's errors: {payload['errors']}")
    require(list(payload["extras"]) == bench_row_names(),
            f"the bench's rows {list(payload['extras'])} are not bench.py's")
    missing = [name for name in BENCH_KERNELS if not counts[name]]
    require(not missing, f"the bench launched no {missing}")
    print(line)
    print(f"bench: {seconds:.1f} s in-process; launches "
          f"{ {name: counts[name] for name in KERNELS if counts[name]} }")
    data = json.loads(detail.read_text())
    require(data["env"]["platform"] == "gpu", f"the bench's env: {data['env']}")
    print(f"bench env: {data['env']['device_kind']}, {data['env'].get('nvidia_smi')}")
    for r in [data["primary"], *data["extras"]]:
        print(f"bench row {r['name']}: {r['gcups']:.2f} GCUPS, {r['seconds'] * 1e3:.3f} ms "
              f"(best of {r['repetitions']}: {r['rep_seconds']}), {r['batch']} x "
              f"{r['seq_len']}, {r['cells']} cells")
    wall_ms = data["primary"]["seconds"] * 1e3
    print(f"bench headline_1400_cuda: {wall_ms:.3f} ms wall clock (MSVScanner.scan and the "
          f"host copy of its scores) against {b1_ms:.3f} ms of B1 by CUDA events (phase 10, "
          f"same shape): the entry point's host share {1 - b1_ms / wall_ms:.2%}")


# -- timings (phase 10) --------------------------------------------------------

def msv_timings(scanner, rng, errors: dict, work: dict) -> dict:
    tokens = rng.integers(0, 20, size=(BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(BATCH, SEQ_LEN, dtype=np.int32))
    out = {}
    for stem, label in (("1400", "GCUPS_M1400"), ("2405", "headline_2405")):
        prof = profile(stem)
        args = msv_args(scanner, prof, staged)
        err, exact = msv_compare(args)
        errors["msv_scan"] = max(errors["msv_scan"], err)
        cells = staged.total_residues * prof.num_states
        ms = best_ms(lambda: msv_cuda.msv_scan_cuda(*args), reps=3)
        out[stem] = ms
        b_ms, b_by = bound(OPS_PER_CELL["msv"](0) * cells, nbytes(*args) + nbytes(exact, *args[5:]))
        print(f"{label}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{BATCH} x {SEQ_LEN} x M={prof.num_states}; kernel vs plain max|d|={err}; "
              f"bound {b_ms:.3f} ms by {b_by}; plan {msv_plan_text(args[0], BATCH)})")
        if stem == "1400":
            # inputs once; the outputs are the scores and carries of the inputs' sizes
            moved = nbytes(*args) + nbytes(exact, *args[5:])
            work["msv_scan"] = work["msv_filter_scan"] = (OPS_PER_CELL["msv"](0) * cells, moved)
            plain_ms = best_ms(lambda: msv_cuda.msv_scan_plain(*args), reps=2)
            out["plain"] = plain_ms
            print(f"plain_GCUPS_M1400: {cells / plain_ms / 1e6:.2f} GCUPS "
                  f"({plain_ms:.3f} ms, best of 2)")
            f_args = msv_args(scanner, prof, staged, filter_mode=True)
            f_ms = best_ms(lambda: msv_cuda.msv_filter_scan_cuda(*f_args), reps=3)
            f_plain_ms, want = once_ms(lambda: msv_cuda.msv_filter_scan_plain(*f_args))
            got = msv_cuda.msv_filter_scan_cuda(*f_args)
            f_err = require_equal(got, want, "MSV filter kernel vs plain at 16384 x 3500")
            require_geq(got[0], exact, "MSV filter vs MSV at 16384 x 3500")
            errors["msv_filter_scan"] = max(errors["msv_filter_scan"], f_err)
            out["filter"] = (f_ms, f_plain_ms)
            print(f"filter_1400: {cells / f_ms / 1e6:.2f} GCUPS ({f_ms:.3f} ms, best of 3); "
                  f"plain version {f_plain_ms:.3f} ms ({cells / f_plain_ms / 1e6:.2f} GCUPS, "
                  f"once), kernel vs plain max|d|={f_err}; plan "
                  f"{msv_plan_text(f_args[0], BATCH)}")
    return out


def p7_timings(scanner, rng, errors: dict, work: dict) -> dict:
    tokens = rng.integers(0, 20, size=(STAGE_BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(STAGE_BATCH, SEQ_LEN, dtype=np.int32))
    p7 = p7_profile("1400")
    cells = staged.total_residues * p7.num_states
    packs = {
        "viterbi_lazy_scan": ("lazy", p7_cuda.viterbi_pack(p7, scanner.device, lazy=True)),
        "viterbi_scan": ("eager", p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)),
        "forward_prob_scan": ("forward", p7_cuda.forward_pack(p7, scanner.device)),
        "viterbi_filter_scan": ("filter", p7_cuda.filter_pack(p7, scanner.device)),
        "forward_log_scan": ("log", p7_cuda.viterbi_pack(p7, scanner.device, lazy=False)),
    }
    out = {}
    for name, (kind, pack) in packs.items():
        run, carry = p7_calls(kind, pack, staged)
        ms = best_ms(lambda: run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry), reps=3)
        got = run(CUDA_FNS[kind], staged.tokens, staged.lengths, carry)
        plain_ms, want = once_ms(lambda: run(PLAIN_FNS[kind], staged.tokens, staged.lengths, carry))
        if kind in ("forward", "log"):
            # 3500 residues of rounding: the Forward tolerance
            err = max_abs_diff(got[0], want[0])
            require(err <= FWD_TOL, f"{kind} Forward kernel vs plain at the stage shape: {err}")
        else:
            err = require_equal(got, want, f"{kind} Viterbi kernel vs plain at the stage shape")
        errors[name] = max(errors[name], err)
        out[name] = (ms, plain_ms)
        if kind == "lazy":
            passes = pack.lazy_k
        elif kind == "filter":
            passes = pack.window
        elif kind == "forward":
            passes = pack.chain.shape[0]
        else:
            passes = p7_cuda.chain_passes(pack.m_pad)
        ops = OPS_PER_CELL[kind](passes) * cells
        if kind == "lazy":  # each replay reruns a chunk (at least its last one) with the full chain
            ops += (int(got[5].sum()) * (SEQ_LEN % p7_cuda.LAZY_CHUNK or p7_cuda.LAZY_CHUNK)
                    * p7.num_states * OPS_PER_CELL["eager"](p7_cuda.chain_passes(pack.m_pad)))
        inputs = (*pack[:4], pack.consts, staged.tokens, staged.lengths, staged.tr_rows, *carry)
        if kind == "forward":
            inputs += (staged.tr_probs,)
        work[name] = (ops, nbytes(*inputs, *got))
        extra = ""
        if kind == "lazy":
            chunks = STAGE_BATCH * -(-SEQ_LEN // p7_cuda.LAZY_CHUNK)
            fired = int(got[5].sum())
            extra = (f", lazy_k={pack.lazy_k}, {fired} of {chunks} chunks replayed "
                     f"({100.0 * fired / chunks:.4f}%)")
        if kind == "filter":
            full = p7_cuda.chain_passes(pack.m_pad)
            extra = f", auto window {pack.window} of {full} passes"
        extra += f"; {plan_text(kind, pack, STAGE_BATCH)}"
        print(f"{name}_1400: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{STAGE_BATCH} x {SEQ_LEN} x M={p7.num_states}{extra}); plain version "
              f"{plain_ms:.3f} ms ({cells / plain_ms / 1e6:.2f} GCUPS, once), kernel vs plain "
              f"max|d|={err:.3g}", flush=True)

    # the survivor shape: one partial wave, G = 1, one step's latency a residue
    few = scanner.stage(tokens[:SURVIVOR_BATCH], np.full(SURVIVOR_BATCH, SEQ_LEN, dtype=np.int32))
    few_cells = few.total_residues * p7.num_states
    for name, (kind, pack) in packs.items():
        run, carry = p7_calls(kind, pack, few)
        ms = best_ms(lambda: run(CUDA_FNS[kind], few.tokens, few.lengths, carry), reps=3)
        out[f"{name}_b64"] = ms
        got = run(CUDA_FNS[kind], few.tokens, few.lengths, carry)
        inputs = (*pack[:4], pack.consts, few.tokens, few.lengths, few.tr_rows, *carry)
        b_ms, b_by = bound(OPS_PER_CELL[kind](passes_of(kind, pack)) * few_cells,
                           nbytes(*inputs, *got))
        print(f"{name}_1400_b64: {few_cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, "
              f"{SURVIVOR_BATCH} x {SEQ_LEN} x M={p7.num_states}; "
              f"{plan_text(kind, pack, SURVIVOR_BATCH)}; bound {b_ms:.3f} ms by {b_by})",
              flush=True)
    return out


def sweep_timings(scanner, rng, errors: dict, work: dict) -> dict:
    """sweep24 / sweep24_filter: the stacked kernel over all 24 profiles at
    SWEEP_BATCH x SEQ_LEN (one launch per register case), best of 3; the
    plain exact sweep once over all 24 profiles, the plain filter sweep
    once over every PLAIN_SWEEP_EVERY-th profile, scaled by cells."""
    tokens = rng.integers(0, 20, size=(SWEEP_BATCH, SEQ_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(SWEEP_BATCH, SEQ_LEN, dtype=np.int32))
    profs = [profile(stem) for stem in stems()]
    cells = staged.total_residues * sum(p.num_states for p in profs)
    groups = {}
    for p in profs:
        groups.setdefault(msv_cuda.kernel_case(msv_cuda.round_up(p.num_states, 8)), []).append(p)
    args = (staged.tokens, staged.lengths, staged.tr_rows)
    out = {}
    for mode, label in (("exact", "sweep24"), ("filter", "sweep24_filter")):
        packs = [scanner._stacked_pack(tuple(g), mode) for g in groups.values()]
        for (lanes, per), grp, (e, c) in zip(groups, groups.values(), packs):
            g_ms = best_ms(lambda: msv_cuda.msv_stacked_scan_cuda(e, *args, c), reps=3)
            mr = sum(p.num_states for p in grp)
            b_ms, b_by = bound(OPS_PER_CELL["msv"](0) * staged.total_residues * mr,
                               nbytes(*args, e, c) + 4 * len(grp) * staged.tokens.shape[0])
            print(f"{label} group {lanes} lanes x {per}: {g_ms:.3f} ms (best of 3), "
                  f"{', '.join(p.name for p in grp)}, sum Mr = {mr} of "
                  f"{len(grp) * lanes * per} kernel states, "
                  f"{staged.total_residues * mr / g_ms / 1e6:.2f} GCUPS; bound {b_ms:.3f} ms "
                  f"by {b_by}; plan {msv_plan_text(e, SWEEP_BATCH)}")
        ms = best_ms(lambda: [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs],
                     reps=3)
        got = [msv_cuda.msv_stacked_scan_cuda(e, *args, c) for e, c in packs]
        subset = profs if mode == "exact" else profs[::PLAIN_SWEEP_EVERY]
        sub_packs = [scanner._stacked_pack((p,), mode) for p in subset]
        plain_ms, want = once_ms(
            lambda: [msv_cuda.msv_stacked_scan_plain(e, *args, c) for e, c in sub_packs])
        sub_cells = staged.total_residues * sum(p.num_states for p in subset)
        scale = cells / sub_cells
        # the subset's rows of the stacked launches against its plain rows
        rows = {p.name: g[k] for g, grp in zip(got, groups.values()) for k, p in enumerate(grp)}
        err = require_equal([rows[p.name] for p in subset], [w[0] for w in want],
                            f"stacked {mode} sweep vs plain at {SWEEP_BATCH} x {SEQ_LEN}")
        errors["msv_stacked_scan"] = max(errors["msv_stacked_scan"], err)
        out[label] = (ms, plain_ms * scale)
        if mode == "exact":
            work["msv_stacked_scan"] = (OPS_PER_CELL["msv"](0) * cells,
                                        nbytes(*args, *(x for pk in packs for x in pk), *got))
        what = ("all 24 profiles" if scale == 1.0 else
                f"{len(subset)} profiles ({', '.join(p.name for p in subset)}), "
                f"{plain_ms:.3f} ms scaled by cells x{scale:.4f}")
        print(f"{label}: {cells / ms / 1e6:.2f} GCUPS ({ms:.3f} ms, best of 3, {SWEEP_BATCH} x "
              f"{SEQ_LEN} x 24 profiles, sum Mr = {sum(p.num_states for p in profs)}, "
              f"{len(groups)} launches); plain version {plain_ms * scale:.3f} ms "
              f"({cells / (plain_ms * scale) / 1e6:.2f} GCUPS, once, {what}); kernel vs plain "
              f"max|d|={err}; plans: "
              f"{'; '.join(msv_plan_text(e, SWEEP_BATCH) for e, _ in packs)}", flush=True)
    return out


def posterior_timings(scanner, rng, errors: dict, work: dict) -> dict:
    """posterior_1400 / posterior_mask_1400: the two posterior kernels at
    POST_TIME_BATCH x POST_TIME_LEN against 1400.hmm, each alone and the
    decode without and with the uint8 mask (best of 3); each plain version
    once on the kernel's inputs, held against it: the row-saving Forward's
    totals (TOT_TOL), the backward pass's coverage on the kernel's rows
    (COV_TOL)."""
    tokens = rng.integers(0, 20, size=(POST_TIME_BATCH, POST_TIME_LEN)).astype(np.int8)
    staged = scanner.stage(tokens, np.full(POST_TIME_BATCH, POST_TIME_LEN, dtype=np.int32))
    p7 = p7_profile("1400")
    cells = staged.total_residues * p7.num_states
    fpack = p7_cuda.forward_pack(p7, scanner.device)
    schain = posterior_cuda.suffix_chain_rows(p7, scanner.device)
    fwd_in = (*fpack[:4], staged.tokens, staged.lengths, staged.tr_rows, staged.tr_probs,
              fpack.consts, *p7_cuda.forward_init_carry(staged.tr_probs, fpack.m_pad))
    save_ms = best_ms(lambda: posterior_cuda.forward_save_scan_cuda(*fwd_in), reps=3)
    saved = posterior_cuda.forward_save_scan_cuda(*fwd_in)
    bwd_in = (fpack.emit_m, fpack.emit_i, fpack.trans, schain, staged.tokens, staged.lengths,
              staged.tr_probs, fpack.consts, saved[0], saved[5], saved[6])
    bwd_ms = best_ms(lambda: posterior_cuda.backward_coverage_scan_cuda(*bwd_in), reps=3)
    cov = posterior_cuda.backward_coverage_scan_cuda(*bwd_in)
    post_ms = best_ms(lambda: posterior_decode(*KERNEL_DECODE, fpack, schain, staged), reps=3)
    mask_ms = best_ms(lambda: (posterior_decode(*KERNEL_DECODE, fpack, schain, staged)[0]
                               >= 0.5).to(torch.uint8), reps=3)
    work["forward_save_scan"] = (OPS_PER_CELL["forward"](fpack.chain.shape[0]) * cells,
                                 nbytes(*fwd_in, *saved))
    work["backward_coverage_scan"] = (OPS_PER_CELL["backward"](schain.shape[0]) * cells,
                                      nbytes(*bwd_in, cov))
    plain_save_ms, p_saved = once_ms(lambda: posterior_cuda.forward_save_scan_plain(*fwd_in))
    # the backward pass's plain version on the kernel's own rows: two
    # forward passes round their rows to bf16 apart (one bf16 ulp moves a
    # coverage by up to 7e-3 on long hits), which is no error of either
    plain_bwd_ms, cov_p = once_ms(lambda: posterior_cuda.backward_coverage_scan_plain(*bwd_in))
    c_err, t_err = max_abs_diff(cov, cov_p), max_abs_diff(saved[0], p_saved[0])
    require(c_err <= COV_TOL and t_err <= TOT_TOL,
            f"posterior kernels vs plain at the bench shape: coverage {c_err}, totals {t_err}")
    errors["backward_coverage_scan"] = max(errors["backward_coverage_scan"], c_err)
    errors["forward_save_scan"] = max(errors["forward_save_scan"], t_err)
    shape = f"{POST_TIME_BATCH} x {POST_TIME_LEN} x M={p7.num_states}"
    print(f"posterior_1400: {cells / post_ms / 1e6:.2f} GCUPS ({post_ms:.3f} ms, best of 3, "
          f"{shape}; the row-saving Forward {save_ms:.3f} ms "
          f"({plan_text('save', fpack, POST_TIME_BATCH)}), the backward coverage pass "
          f"{bwd_ms:.3f} ms ({plan_text('backward', fpack, POST_TIME_BATCH)}), each best of 3; "
          f"bound {bound(*work['backward_coverage_scan'])[0]:.3f} ms); plain versions "
          f"{plain_save_ms:.3f} + "
          f"{plain_bwd_ms:.3f} ms (once); kernels vs plain coverage max|d|={c_err:.3g} "
          f"totals max|d|={t_err:.3g}")
    print(f"posterior_mask_1400: {cells / mask_ms / 1e6:.2f} GCUPS ({mask_ms:.3f} ms, best of 3, "
          f"{shape}, the decode and the uint8 cov >= 0.5 mask)", flush=True)
    return {"forward_save_scan": (save_ms, plain_save_ms),
            "backward_coverage_scan": (bwd_ms, plain_bwd_ms)}


def main() -> int:
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    scanner = MSVScanner(device=dev)
    rng = np.random.default_rng(SEED)
    errors = dict.fromkeys(KERNELS, 0.0)

    with Phase("2. build"):
        t0 = time.perf_counter()
        loaded = native.native_available()  # the CLI's parser; it falls back to Python without it
        print(f"native loader: {native._lib_path().name if loaded else native._load_error} "
              f"({time.perf_counter() - t0:.2f} s)")
        lib_path, log = _build.build()
        print(f"library: {lib_path}")
        print("\n".join(ptxas_summary(log)))
        print_msv_plans(scanner)
        print_plans(scanner)

    with Phase("3. log-space Forward and posterior kernels vs plain, 24 profiles"):
        new_kernels_vs_plain(scanner, rng, errors)

    with Phase("4. MSV kernels (exact, filter, stacked) vs plain, 24 profiles"):
        msv_kernels_vs_plain(scanner, rng, errors)

    with Phase("5. MSV kernel vs oracle"):
        lengths8 = np.minimum([0, 1, 32, 100, 257, 1000, 2048, SEQ_LEN], SEQ_LEN).astype(np.int32)
        tokens8 = rng.integers(0, 20, size=(8, SEQ_LEN)).astype(np.int32)
        staged8 = scanner.stage(tokens8, lengths8)
        for stem in ("1400", "2405"):
            prof = profile(stem)
            got = scanner.scan(prof, staged8).cpu().numpy()
            require(np.array_equal(got, msv_oracle_batch(prof, tokens8, lengths8)),
                    f"kernel != oracle on {stem}.hmm")
            print(f"kernel vs oracle {stem}.hmm: 8 seqs, equal (max|d|=0.0)")

    with Phase("6. Viterbi/Viterbi filter/Forward kernels vs plain, 24 profiles"):
        p7_kernels_vs_plain(scanner, rng, errors)

    with Phase("7. Viterbi/Forward/log-space Forward/posterior kernels vs oracle"):
        p7_kernels_vs_oracle(scanner, rng, errors)
        new_kernels_vs_oracle(scanner, rng, errors)

    with Phase("8. profiles wider than 2432 states: every kernel's wide, MSV cluster and "
               "rows-in-memory cases vs plain"):
        wide_kernels_vs_plain(scanner, rng, errors)
        cluster_kernels_vs_plain(scanner, rng, errors)
        mem_kernels_vs_plain(scanner, rng, errors)
        block_cluster_kernels_vs_plain(scanner, rng, errors)
        release_stress()

    # phase 11 reads phase 9's database and reports
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        with Phase("9. main paths through the CLI and the entry points"):
            counts = main_paths(tmp, rng, scanner)
            counts.update(mem_paths(tmp, rng))

        work = {}
        with Phase("10. timings"):
            msv_ms = msv_timings(scanner, rng, errors, work)
            p7_ms = p7_timings(scanner, rng, errors, work)
            sweep_ms = sweep_timings(scanner, rng, errors, work)
            post_ms = posterior_timings(scanner, rng, errors, work)
            wide_ms = wide_timings(scanner, rng, errors, work)
            mem_ms = mem_timings(scanner, rng, errors, work)
            print("card after timing:",
                  nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))

        with Phase("11. database-scale paths: --stream, --bucketed, --checkpoint"):
            database_paths(tmp)

        with Phase("12. build on the card, scan --align/--msa-out, --config, --profile-trace, "
                   "info/emit/generate"):
            subcommand_paths(tmp)

        with Phase("13. the device mesh: db-sharded stages, the sp wavefront, --mesh, "
                   "dryrun_multichip"):
            mesh_paths(tmp, scanner, errors)

        with Phase("14. fuzzed profiles: every kernel vs plain"):
            fuzz_kernels_vs_plain(scanner, errors)

        with Phase("15. the fused cascade: scan --stage search --fused"):
            fused_cli(tmp)
            fused_library(tmp, scanner)

        with Phase("16. the bench: python -m hmm_fasta_viterbi_tpu_torch.bench --e2e"):
            bench_rows(tmp, rng, msv_ms["1400"])

    times = {"msv_scan": (msv_ms["1400"], msv_ms["plain"]), "msv_filter_scan": msv_ms["filter"],
             "msv_stacked_scan": sweep_ms["sweep24"], **post_ms, **wide_ms, **mem_ms,
             **{name: p7_ms[name] for name in KERNELS if name in p7_ms}}
    bounds = {name: bound(*work[name]) for name in KERNELS}
    for name, (ms, by) in bounds.items():
        ops, moved = work[name]
        print(f"bound {name}: {ms:.3f} ms by {by} ({ops:.4g} FP32 operations, {moved:.4g} "
              f"bytes); the kernel {times[name][0]:.3f} ms, roofline share "
              f"{ms / times[name][0]:.2%}")
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"hmm_fasta_viterbi_tpu_torch/{source}",
            "replaces": replaces,
            "mode": mode,
            "launches": counts[name],
            "max_abs_err": errors[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            # no single PyTorch call computes one of these DP scans
            "library_ms": None,
        }
        for name, (source, replaces, mode) in KERNELS.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
