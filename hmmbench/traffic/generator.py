"""The benchmark's one generator: a configuration's sequence database and
a traffic mix's queries.

The database's rows come from the configuration's ``content_seed``, and
``--seed`` draws their order (and the queries' order, and the check's
sample): every seed is given the same work, in another order, so that the
spread between runs is the system's and not the data's.

* row lengths are the quantiles ``(i + 1/2) / n`` of the configuration's
  fitted lognormal, clipped to its range; where the configuration names
  its source's longest entries (``longest_entries``), they take the
  places of the longest quantiles;
* residues are drawn on the device from the configuration's amino-acid
  composition, with a ``torch.Generator``;
* each library family is planted, as one domain sampled by
  ``emit.emit_domains``, in its share of the rows (distinct rows); a row
  shorter than its domain grows to hold it.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``),
run as a closed loop with one query in flight:

* ``profiles_per_query``: 1 (hmmsearch: one profile against the database
  a query) or ``"all"`` (hmmscan: every library profile a query);
* ``rounds``: ``"permuted"``, each round of the library a fresh
  permutation drawn from the seed (independent users' queries: every
  window holds nearly equal counts of each profile), or ``"fixed"``, one
  seeded order kept for every round (hmmscan reads its library in the
  same order for every sequence);
* ``check_queries``, ``check_rows``: the sample the check compares
  (``check.py``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from ..reference import hmm as hmm_mod
from . import emit

HERE = pathlib.Path(__file__).resolve().parent
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def seed_bits(seed: int) -> int:
    """``--seed`` as the 64-bit pattern both generators take (any whole
    number, negative ones too)."""
    return int(seed) & (2**64 - 1)


def load_traffic(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def fixed_lengths(rows: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The ``rows`` quantiles of lognormal(ln median, sigma), rounded and
    clipped to [lo, hi], ascending (int32)."""
    p = (torch.arange(rows, dtype=torch.float64) + 0.5) / rows
    z = torch.special.ndtri(p).numpy()
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int32)


def config_lengths(config: dict) -> np.ndarray:
    """The configuration's row lengths, ascending: the lognormal's
    quantiles, the longest of them replaced by ``longest_entries`` (its
    source's own longest rows) where the configuration names them."""
    lengths = fixed_lengths(int(config["rows"]), config["length_median"], config["length_sigma"],
                            config["length_min"], config["length_max"])
    named = sorted(config.get("longest_entries", {}).values())
    if named:
        lengths[len(lengths) - len(named):] = named
    return lengths


def composition(config: dict) -> np.ndarray:
    freq = np.array([config["composition"][a] for a in AMINO], dtype=np.float64)
    return freq / freq.sum()


@dataclasses.dataclass
class Database:
    tokens: np.ndarray  # [rows, L_max] int8, 0 past each row's length
    lengths: np.ndarray  # [rows] int32
    family: np.ndarray  # [rows] int16: the planted library profile, -1 for none

    @property
    def residues(self) -> int:
        return int(self.lengths.astype(np.int64).sum())


def make_database(config: dict, library: list, seed: int, device) -> Database:
    """The configuration's database in ``seed``'s row order: ``library``
    is the profiles parsed with ``star_as_zero`` (``reference.hmm.parse``),
    in the configuration's order. The rows themselves (lengths, residues,
    planted domains) come from the configuration's ``content_seed``, so
    every seed is given the same work in another order."""
    rng = np.random.default_rng(seed_bits(config["content_seed"]))
    n = int(config["rows"])
    lengths = rng.permutation(config_lengths(config))
    per_family = int(round(config["planted_share"] * n))
    planted = rng.choice(n, size=per_family * len(library), replace=False)
    planted = planted.reshape(len(library), per_family)
    family = np.full(n, -1, dtype=np.int16)
    spots, residues = [], []
    for f, (rows, h) in enumerate(zip(planted, library)):
        doms = emit.emit_domains(h, per_family, rng, config["length_max"])
        family[rows] = f
        dlen = np.array([len(d) for d in doms], dtype=np.int64)
        lengths[rows] = np.maximum(lengths[rows], dlen)
        offsets = rng.integers(0, lengths[rows] - dlen + 1)
        within = np.arange(dlen.sum()) - np.repeat(np.cumsum(dlen) - dlen, dlen)
        spots.append((np.repeat(rows, dlen), np.repeat(offsets, dlen) + within))
        residues.append(np.concatenate(doms))

    l_max = int(lengths.max())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(config["content_seed"]))
    cdf = torch.from_numpy(np.cumsum(composition(config))).to(device=device, dtype=torch.float64)
    draws = torch.rand(int(lengths.astype(np.int64).sum()), generator=gen, device=device,
                       dtype=torch.float64)
    drawn = torch.clamp(torch.searchsorted(cdf, draws, right=True), max=19).to(torch.int8)
    del draws
    grid = torch.zeros((n, l_max), dtype=torch.int8, device=device)
    lengths_d = torch.from_numpy(lengths).to(device)
    grid[torch.arange(l_max, device=device)[None, :] < lengths_d[:, None]] = drawn
    del drawn
    rows = torch.from_numpy(np.concatenate([r for r, _ in spots])).to(device)
    cols = torch.from_numpy(np.concatenate([c for _, c in spots])).to(device)
    grid[rows, cols] = torch.from_numpy(np.concatenate(residues)).to(device)

    order = np.random.default_rng([seed_bits(seed), 4]).permutation(n)
    tokens = grid[torch.from_numpy(order).to(device)].cpu().numpy()
    del grid
    return Database(tokens, lengths[order], family[order])


def library_paths(config: dict, root: pathlib.Path) -> list[pathlib.Path]:
    return [root / config["library_dir"] / f"{name}.hmm" for name in config["library"]]


def parse_library(config: dict, root: pathlib.Path) -> list:
    """The library parsed for sampling (``*`` an impossible move)."""
    return [hmm_mod.parse(p, star_as_zero=True) for p in library_paths(config, root)]


def queries(traffic: dict, n_profiles: int, seed: int):
    """Endless query schedule, each query a tuple of library indices:
    rounds of the whole library, each in a fresh seeded order
    (``rounds: "permuted"``) or all in one (``"fixed"``)."""
    rng = np.random.default_rng([seed_bits(seed), 1])
    per = traffic["profiles_per_query"]
    per = n_profiles if per == "all" else int(per)
    if traffic["rounds"] not in ("permuted", "fixed"):
        raise ValueError(f"rounds must be 'permuted' or 'fixed', got {traffic['rounds']!r}")
    order = rng.permutation(n_profiles)
    while True:
        for start in range(0, n_profiles - per + 1, per):
            yield tuple(int(p) for p in order[start: start + per])
        if traffic["rounds"] == "permuted":
            order = rng.permutation(n_profiles)
