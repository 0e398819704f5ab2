"""Tiny cells for the tests: the real configurations and traffic mixes,
with fewer rows, shorter rows and two small profiles."""

import time

from hmmbench import harness


def tiny_cell(name: str = "sprot_search.pfam24", rows: int = 300,
              library=("100", "200"), length_max: int = 500, share: float = 0.01):
    cell = harness.load_cell(name)
    cell.config.update(rows=rows, library=list(library), length_max=length_max,
                       planted_share=share)
    return cell


def run_tiny(cell, seed: int = 5, seconds: float = 0.5, traced: bool = False, device="cpu",
             options=None) -> dict:
    return harness.run(cell, seed, seconds, traced, device, time.perf_counter(), options)
