"""The paper's Fig 11 study on the CPU, port against the reference package.

The study's 8 grids (`benchmarks/bench_combinations.py`: the base
configuration and the 7 combinations of {HS, B, TS}, HS as the
`n_active_hosts` dyn value, B a battery of the workload's kWh a host, TS
temporal shifting) over 4 carbon regions of a small SURF at the study's 256
slots a step, each one `sweep_grid` through the megakernel:
`carbon_reduction_pct` against the base grid within rtol 1e-4, the
`techniques` labels equal, the outcome counts exact.  The full study runs on
the card in scripts/paper_workloads_card.py.
"""
from __future__ import annotations

import functools

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces import make_region_traces
import repro_torch.core as P
import repro_torch.core.config as pconfig

from test_torch_paper_workloads import (COMBOS, COUNT_FIELDS, DT, TOTALS,
                                        _config, _dyn, _workload)

torch.set_num_threads(1)

GRID_CASE = ("surf", 0.1, 1.0, 4)   # workload, scale, days, regions


@functools.lru_cache(maxsize=None)
def _grid_case():
    name, scale, days, regions = GRID_CASE
    jt, jh, pt, ph, meta, steps = _workload(name, scale, days)
    traces = make_region_traces(steps, DT, regions, seed=0)
    out = {}
    for combo in COMBOS:
        hs = "H" in combo
        jc = _config(jconfig, name, steps, meta, combo, "megakernel")
        pc = _config(pconfig, name, steps, meta, combo, "megakernel")
        dyn = _dyn(combo, meta)
        jr = J.sweep_grid(jt, jh, jc, [J.trace_axis(traces)], dyn=dyn)
        pr = P.sweep_grid(pt, ph, pc, [P.trace_axis(torch.as_tensor(traces))],
                          dyn=dyn, device="cpu")
        out[combo] = (jr, pr, jconfig.techniques(jc, horizontal_scaling=hs),
                      pconfig.techniques(pc, horizontal_scaling=hs))
    return out


@pytest.mark.parametrize("combo", COMBOS[1:])
def test_study_grid_matches_reference(combo):
    grids = _grid_case()
    jb, pb = grids[""][0], grids[""][1]
    jr, pr, jlabel, plabel = grids[combo]
    assert plabel == jlabel
    want = np.asarray(J.carbon_reduction_pct(jb, jr))
    got = P.carbon_reduction_pct(pb, pr).numpy()
    assert got.shape == want.shape == (GRID_CASE[3],)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.0)
    for k in COUNT_FIELDS[:3]:
        np.testing.assert_array_equal(getattr(pr, k).numpy(),
                                      np.asarray(getattr(jr, k)), err_msg=k)


def test_study_base_grid_matches_reference():
    jb, pb, jlabel, plabel = _grid_case()[""]
    assert plabel == jlabel == "none"
    for k in TOTALS:
        np.testing.assert_allclose(getattr(pb, k).numpy(),
                                   np.asarray(getattr(jb, k)), rtol=1e-4,
                                   atol=0.0, err_msg=k)
