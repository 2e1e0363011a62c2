"""SURF's whole 124-day horizon (11,904 steps of 0.25 h) at a tiny scale,
port against the reference package on the CPU: the base configuration at
the study's 256 slots a step through both step executors, each against the
reference's same executor (outcome counts exact, totals within rtol 1e-4),
and the port's executors' gap beside the reference's own.  Kernel 3's
facility half spans 12 tiles of 1024 steps here (the last partial), as on
the card at full scale (`chip_smoke.py` phase 4g).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_paper_workloads import (TOTALS, _reference_run,
                                        assert_same, port_run)

torch.set_num_threads(1)

# SURF at a hundredth (4 hosts), its task count capped (2 hosts, 600 tasks)
SCALE, DAYS, CAP = 0.01, 124.0, 600


@functools.lru_cache(maxsize=None)
def _port(backend: str) -> dict:
    return port_run("surf", "", backend, SCALE, DAYS, CAP)


@pytest.mark.parametrize("backend", ("stage-pipeline", "megakernel"))
def test_surf_whole_horizon_matches_reference(backend):
    got = _port(backend)
    want = _reference_run("surf", "", backend, SCALE, DAYS, CAP)
    assert_same(got, want, 1e-4)
    assert got["n_done"] > 0


def test_surf_whole_horizon_executor_gap_is_the_reference_s():
    """The port's two executors differ by no more than the reference's
    two do, plus the 1e-5 the reference allows between its own."""
    got = {b: _port(b) for b in ("stage-pipeline", "megakernel")}
    want = {b: _reference_run("surf", "", b, SCALE, DAYS, CAP)
            for b in ("stage-pipeline", "megakernel")}
    for k in TOTALS:
        def gap(r):
            a, b = np.float64(r["stage-pipeline"][k]), np.float64(
                r["megakernel"][k])
            return abs(a - b) / max(abs(b), 1e-30)
        assert gap(got) <= gap(want) + 1e-5, k
