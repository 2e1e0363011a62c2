"""The port's telemetry layer (repro_torch/core/telemetry.py) against the
reference's (repro/core/telemetry.py) on the same numpy inputs, on the CPU.

The workload, traces and probe cases are those of tests/test_telemetry.py:

  * the disabled path: `probes` is None, the scopes are null contexts, and
    a session moves no result bit (simulate and sweep_grid);
  * the probe bus on both executors against the reference's probes: steps
    exactly, values within rtol 1e-5 / atol 1e-4 (the reference's bound
    between its own executors); ring wrap, the resilience channels, the
    queue depth, grid probes (and `reduce`), `window_peak_series` bit for
    bit;
  * the recompile guard's policies, driven through the build-event hook
    that kernels/build.py calls;
  * run records: the reference's kinds and counts for simulate, a chunked
    grid and a fleet, the chunk plan, trace dtypes, the config hash, the
    JSONL round trip;
  * kernel 3's series entry (`ops.fused_facility_chain`) on the CPU equal
    to the plain chain, the chiller-derate echo included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.core import telemetry as jtel
from repro.core.fleet import FleetSpec as JFleetSpec
from repro.kernels import ref as jref
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro_torch.core import engine as pengine
from repro_torch.core import telemetry as tel
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import fused_step as fs

torch.set_num_threads(1)

S = 96
DT = 0.25

_rng0 = np.random.default_rng(33)
_N = 12
J_TASKS = J.make_task_table(np.sort(_rng0.uniform(0.0, 8.0, _N)),
                            _rng0.uniform(0.5, 4.0, _N),
                            _rng0.integers(1, 3, _N).astype(float))
J_HOSTS = J.make_host_table(3, 4)


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


TASKS, HOSTS = P.tables_from_numpy(_np(J_TASKS), _np(J_HOSTS), device="cpu")


def _traces(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(S) * DT
    ci = (250 + 150 * np.sin(2 * np.pi * t / 24 + rng.uniform(0, 6))
          + rng.normal(0, 10, S)).clip(5.0).astype(np.float32)
    price = (0.12 * (1 + 0.8 * np.sin(2 * np.pi * t / 24))
             + rng.exponential(0.01, S)).clip(0.005).astype(np.float32)
    wb = (14 + 6 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    cf = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0,
                 1.0).astype(np.float32)
    return ci, price, wb, cf


CI, PRICE, WB, CF = _traces(5)


def _cfg(C, cool=False, price=False, renew=False, batt=True, **kw):
    base = dict(
        n_steps=S,
        cooling=C.CoolingConfig(enabled=cool),
        pricing=C.PricingConfig(enabled=price, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=renew, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=batt, capacity_kwh=6.0))
    base.update(kw)
    return C.SimConfig(**base)


def _dyn(cfg) -> dict:
    d = {}
    if cfg.pricing.enabled:
        d["price_trace"] = PRICE
    if cfg.cooling.enabled:
        d["wet_bulb_trace"] = WB
    if cfg.renewables.enabled:
        d["pv_cf_trace"] = CF
    return d


def _run(cfg, tasks=TASKS, hosts=HOSTS):
    final, _ = P.simulate(tasks, hosts, CI, cfg, dyn=_dyn(cfg), device="cpu")
    return P.summarize(final, cfg)


def _jrun(cfg, tasks=J_TASKS, hosts=J_HOSTS):
    dyn = {k: jnp.asarray(v) for k, v in _dyn(cfg).items()}
    final, _ = J.simulate(tasks, hosts, CI, cfg, dyn=dyn)
    return J.summarize(final, cfg)


def _same_probes(got, want, rtol=1e-5, atol=1e-4, what=""):
    """Port probes against reference probes: steps exactly, values within
    the reference's bound (its own executors')."""
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step),
                                  err_msg=f"{what} step")
    for f in tel.PROBE_VALUE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {f}")


def _assert_results_equal(a, b):
    """Every field (the probes' too) bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        pairs = zip(x, y) if isinstance(x, tel.Probes) else [(x, y)]
        for u, v in pairs:
            assert torch.equal(u, v) or (torch.isnan(u).any() and torch.equal(
                torch.nan_to_num(u), torch.nan_to_num(v))), f


# ---------------------------------------------------------------------------
# 1. disabled by default, and a session moves no bit
# ---------------------------------------------------------------------------

class TestDisabledPath:
    def test_disabled_by_default(self):
        assert not tel.enabled() and tel.get() is None
        assert _run(_cfg(pconfig)).probes is None

    def test_scopes_are_null_contexts_when_disabled(self):
        assert isinstance(tel.span("x"), contextlib.nullcontext)
        assert isinstance(tel.stage_scope("x"), contextlib.nullcontext)
        assert isinstance(tel.stage_scope("x", "cpu"),
                          contextlib.nullcontext)

    def test_no_session_composes_the_stages_as_they_are(self):
        stages = pengine.default_pipeline(_cfg(pconfig))
        assert pengine._scoped(stages) is stages

    def test_scopes_under_a_session_on_the_cpu(self, tmp_path):
        """On the CPU a scope is the profiler's range alone (no NVTX, which
        this build does not have): entering it works."""
        with tel.session(out_dir=str(tmp_path), export=False):
            scope = tel.stage_scope("stage_power", torch.device("cpu"))
            assert not isinstance(scope, contextlib.nullcontext)
            with scope:
                pass
            stages = pengine.default_pipeline(_cfg(pconfig))
            scoped = pengine._scoped(stages)
            assert scoped is not stages and len(scoped) == len(stages)

    @pytest.mark.parametrize("probes", [False, True])
    def test_enabled_session_is_bitwise_identical(self, tmp_path, probes):
        cfg = _cfg(pconfig, cool=True, price=True, renew=True,
                   probes=pconfig.ProbeConfig(enabled=probes, stride=3))
        base = [_run(cfg.replace(backend=b)) for b in P.BACKENDS]
        with tel.session(out_dir=str(tmp_path)):
            inst = [_run(cfg.replace(backend=b)) for b in P.BACKENDS]
        assert not tel.enabled()
        for a, b in zip(base, inst):
            _assert_results_equal(a, b)

    def test_grid_sweep_identical_with_and_without_session(self, tmp_path):
        cfg = _cfg(pconfig, probes=pconfig.ProbeConfig(enabled=True,
                                                       stride=8))
        axes = [P.dyn_axis(batt_capacity_kwh=np.array([2.0, 6.0, 12.0],
                                                      np.float32))]
        plain = P.sweep_grid(TASKS, HOSTS, cfg, axes, CI, device="cpu")
        with tel.session(out_dir=str(tmp_path)):
            inst = P.sweep_grid(TASKS, HOSTS, cfg, axes, CI, chunk_size=2,
                                device="cpu")
        _assert_results_equal(plain, inst)


# ---------------------------------------------------------------------------
# spans and the Chrome trace
# ---------------------------------------------------------------------------

class TestSpans:
    def test_session_exports_valid_chrome_trace(self, tmp_path):
        with tel.session(out_dir=str(tmp_path)) as t:
            with t.span("outer", detail="unit"):
                _run(_cfg(pconfig))
            assert t.span_durations("outer")
        with open(os.path.join(str(tmp_path), "trace.json")) as f:
            trace = json.load(f)
        names = {e["name"] for e in trace["traceEvents"]}
        assert "outer" in names and "simulate" in names
        for ev in trace["traceEvents"]:
            assert ev["ph"] == "X" and ev["dur"] >= 0.0 and ev["ts"] >= 0.0

    def test_grid_run_emits_build_execute_and_chunk_spans(self, tmp_path):
        caps = np.array([2.0, 6.0, 12.0, 20.0], np.float32)
        with tel.session(out_dir=str(tmp_path), export=False) as t:
            P.sweep_grid(TASKS, HOSTS, _cfg(pconfig),
                         [P.dyn_axis(batt_capacity_kwh=caps)], CI,
                         chunk_size=2, device="cpu")
            names = [e["name"] for e in t.events]
        assert "grid.build" in names and "grid.execute" in names
        assert names.count("grid.chunk") == 2

    def test_fleet_emits_its_place_span(self, tmp_path):
        fleet = P.FleetSpec(ci_traces=np.stack([CI, CI[::-1]]))
        with tel.session(out_dir=str(tmp_path), export=False) as t:
            P.simulate_fleet(TASKS, HOSTS, _cfg(pconfig, batt=False), fleet,
                             device="cpu")
            place = [e for e in t.events if e["name"] == "fleet.place"]
        assert len(place) == 1 and place[0]["args"]["policy"] == "greedy"

    def test_profile_writes_a_chrome_trace(self, tmp_path):
        cfg = _cfg(pconfig, batt=False)
        with tel.session(out_dir=str(tmp_path), export=False):
            out, logdir = tel.profile(lambda: _run(cfg),
                                      logdir=str(tmp_path / "prof"))
        assert out.probes is None and os.path.isdir(logdir)
        with open(os.path.join(logdir, "trace.json")) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        # the session's stage scopes are in the device-side trace
        assert "stage_scheduler" in names and "stage_carbon" in names


# ---------------------------------------------------------------------------
# 2. the probe bus against the reference
# ---------------------------------------------------------------------------

PROBE_CASES = [
    # (cool, price, renew, stride, max_samples)
    (False, False, False, 1, 0),
    (True, False, False, 1, 0),
    (False, True, False, 3, 0),
    (True, True, True, 1, 0),
    (True, True, True, 4, 0),
    (False, True, True, 3, 10),   # ring wrap: keeps the LAST 10 samples
]


def _probe_cfgs(cool, price, renew, stride, cap, **kw):
    return [_cfg(C, cool, price, renew,
                 probes=C.ProbeConfig(enabled=True, stride=stride,
                                      max_samples=cap), **kw)
            for C in (jconfig, pconfig)]


@functools.lru_cache(maxsize=None)
def _ref_probes(case):
    return _jrun(_probe_cfgs(*case)[0]).probes


class TestProbeBus:
    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    @pytest.mark.parametrize("case", PROBE_CASES)
    def test_probes_match_the_reference(self, case, backend):
        pc = _probe_cfgs(*case)[1].replace(backend=backend)
        got = _run(pc).probes
        k = tel.probe_capacity(S, pc.probes)
        assert got.step.shape == (k,) and got.step.dtype == torch.int32
        _same_probes(got, _ref_probes(case), what=backend)

    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    def test_probes_match_collect_series_slices(self, backend):
        """stride-1 probes are the per-step flow series: the stage
        pipeline's probe stage copies the settled ledger, the megakernel
        gathers the same facility series it returns."""
        cfg = _cfg(pconfig, cool=True, price=True, renew=True,
                   collect_series=True, backend=backend,
                   probes=pconfig.ProbeConfig(enabled=True, stride=1))
        final, series = P.simulate(TASKS, HOSTS, CI, cfg, dyn=_dyn(cfg),
                                   device="cpu")
        p = P.summarize(final, cfg).probes
        np.testing.assert_array_equal(p.step.numpy(), np.arange(S))
        for f in P.EnergyFlow._fields:
            assert torch.equal(getattr(p, f), getattr(series["flow"], f)), f
        assert torch.equal(p.soc_kwh, series["battery_charge"])

    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    def test_ring_wrap_keeps_last_samples(self, backend):
        cfg = _cfg(pconfig, backend=backend,
                   probes=pconfig.ProbeConfig(enabled=True, stride=2,
                                              max_samples=7))
        p = _run(cfg).probes
        total = -(-S // 2)                      # 48 strided samples
        want = [(j + ((total - 1 - j) // 7) * 7) * 2 for j in range(7)]
        np.testing.assert_array_equal(p.step.numpy(), want)
        assert tel.sample_steps(S, cfg.probes) == want

    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    def test_resilience_channels_healthy_defaults(self, backend):
        cfg = _cfg(pconfig, backend=backend,
                   probes=pconfig.ProbeConfig(enabled=True, stride=1))
        p = _run(cfg).probes
        assert bool((p.throttle_factor == 1.0).all())
        assert bool((p.chiller_derate == 1.0).all())
        assert bool(torch.isinf(p.pdu_cap_kw).all())

    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    def test_resilience_channels_match_reference(self, backend):
        """Hazards forced high so every loop bites: the port's channels on
        each executor against the reference's in-scan samples."""
        jc, pc = [_cfg(C, cool=True,
                       resilience=C.ResilienceConfig(
                           enabled=True, chiller_mtbf_h=8.0,
                           chiller_repair_h=6.0, pdu_mtbf_h=12.0,
                           pdu_repair_h=4.0, pdu_cap_kw=5.0,
                           throttle_inlet_c=10.0, throttle_factor=0.5),
                       probes=C.ProbeConfig(enabled=True, stride=1))
                  for C in (jconfig, pconfig)]
        want = _jrun(jc).probes
        got = _run(pc.replace(backend=backend)).probes
        for f in ("throttle_factor", "chiller_derate", "pdu_cap_kw"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-6, err_msg=f)
        _same_probes(got, want, what=backend)
        assert float(got.chiller_derate.min()) < 1.0
        assert float(got.throttle_factor.min()) < 1.0
        assert float(got.pdu_cap_kw.min()) == 5.0
        assert float(got.throttle_factor[0]) == 1.0

    @pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
    def test_queue_depth_matches_reference(self, backend):
        # oversubscribed on purpose: 8 two-core tasks, one 4-core host
        jt = J.make_task_table(np.zeros(8), np.full(8, 2.0), np.full(8, 2.0))
        jh = J.make_host_table(1, 4)
        pt, ph = P.tables_from_numpy(_np(jt), _np(jh), device="cpu")
        jc, pc = [_cfg(C, probes=C.ProbeConfig(enabled=True, stride=1))
                  for C in (jconfig, pconfig)]
        qd = _run(pc.replace(backend=backend), pt, ph).probes.queue_depth
        want = np.asarray(_jrun(jc, jt, jh).probes.queue_depth)
        np.testing.assert_array_equal(qd.numpy(), want)
        assert float(qd.max()) > 0 and float(qd[-1]) == 0.0

    def test_probes_ride_through_the_grid(self):
        """Grid probes have shape (*grid.shape, K); each cell equals its
        own run and the reference's grid cell."""
        jc, pc = [_cfg(C, probes=C.ProbeConfig(enabled=True, stride=8))
                  for C in (jconfig, pconfig)]
        caps = np.array([2.0, 6.0], np.float32)
        traces = np.stack([CI, CI[::-1]])
        axes = lambda M: [M.trace_axis(traces),  # noqa: E731
                          M.dyn_axis(batt_capacity_kwh=caps)]
        res = P.sweep_grid(TASKS, HOSTS, pc, axes(P), device="cpu")
        want = J.sweep_grid(J_TASKS, J_HOSTS, jc, axes(J))
        k = tel.probe_capacity(S, pc.probes)
        assert res.probes.it_kw.shape == (2, 2, k)
        _same_probes(res.probes, want.probes, what="grid")
        for i, j in np.ndindex(2, 2):
            final, _ = P.simulate(TASKS, HOSTS, traces[i], pc,
                                  dyn={"batt_capacity_kwh": caps[j]},
                                  device="cpu")
            own = P.summarize(final, pc).probes
            for f in tel.Probes._fields:
                assert torch.equal(getattr(res.probes, f)[i, j],
                                   getattr(own, f)), f"{f} cell {i}, {j}"

    @pytest.mark.parametrize("op", ["min", "argmax"])
    def test_grid_probes_under_reduce(self, op):
        jc, pc = [_cfg(C, probes=C.ProbeConfig(enabled=True, stride=8))
                  for C in (jconfig, pconfig)]
        caps = np.array([2.0, 6.0, 9.0], np.float32)
        traces = np.stack([CI, CI[::-1]])
        axes = lambda M: [M.trace_axis(traces),  # noqa: E731
                          M.dyn_axis(batt_capacity_kwh=caps)]
        full = P.sweep_grid(TASKS, HOSTS, pc, axes(P), device="cpu")
        red = P.sweep_grid(TASKS, HOSTS, pc, axes(P), reduce=(op, 1),
                           device="cpu")
        want = J.sweep_grid(J_TASKS, J_HOSTS, jc, axes(J), reduce=(op, 1))
        fn = {"min": torch.amin, "argmax": torch.argmax}[op]
        for f in tel.Probes._fields:
            got = getattr(red.probes, f)
            assert got.shape == (2, tel.probe_capacity(S, pc.probes)), f
            assert torch.equal(got, fn(getattr(full.probes, f), dim=1)), f
        if op == "min":
            _same_probes(red.probes, want.probes, what="reduce")
        else:
            np.testing.assert_array_equal(red.probes.step.numpy(),
                                          np.asarray(want.probes.step))

    def test_fleet_carries_per_region_probes(self):
        jc, pc = [_cfg(C, batt=False,
                       probes=C.ProbeConfig(enabled=True, stride=4))
                  for C in (jconfig, pconfig)]
        traces = np.stack([CI, CI[::-1]])
        got = P.simulate_fleet(TASKS, HOSTS, pc, P.FleetSpec(
            ci_traces=traces), device="cpu")
        want = J.simulate_fleet(J_TASKS, J_HOSTS, jc,
                                JFleetSpec(ci_traces=traces))
        assert got.total.probes is None and want.total.probes is None
        assert got.per_region.probes.step.shape == (2, S // 4)
        _same_probes(got.per_region.probes, want.per_region.probes,
                     what="fleet")

    @pytest.mark.parametrize("shape", [(50,), (3, 50)])
    @pytest.mark.parametrize("w", [1, 7, 50, 64])
    def test_window_peak_series_bit_equal_to_reference(self, shape, w):
        grid = np.random.default_rng(w).uniform(0, 100, shape).astype(
            np.float32)
        got = tel.window_peak_series(torch.from_numpy(grid), w).numpy()
        rows = grid.reshape(-1, shape[-1])
        want = np.stack([np.asarray(jtel.window_peak_series(
            jnp.asarray(r), w)) for r in rows]).reshape(shape)
        np.testing.assert_array_equal(got, want)

    def test_probes_from_series_matches_reference(self):
        rng = np.random.default_rng(3)
        series = {f: rng.uniform(0, 10, S).astype(np.float32)
                  for f in tel.PROBE_VALUE_FIELDS}
        pcfg = pconfig.ProbeConfig(enabled=True, stride=3, max_samples=11)
        got = tel.probes_from_series(
            S, pcfg, {k: torch.from_numpy(v) for k, v in series.items()})
        want = jtel.probes_from_series(
            S, jconfig.ProbeConfig(enabled=True, stride=3, max_samples=11),
            series)
        _same_probes(got.probes(), want, rtol=0.0, atol=0.0)

    def test_probe_write_keeps_the_ring_and_skips_unsampled_steps(self):
        pcfg = pconfig.ProbeConfig(enabled=True, stride=2, max_samples=3)
        ring = tel.init_probes(10, pcfg, (2,), "cpu")
        assert ring.values.shape == (2, len(tel.PROBE_VALUE_FIELDS), 3)
        for i in range(10):
            vals = {f: torch.full((2, 1), float(i)) for f in
                    tel.PROBE_VALUE_FIELDS}
            assert tel.probe_write(ring, i, 2, vals) is ring
        p = ring.probes()
        np.testing.assert_array_equal(p.step.numpy(), [[6, 8, 4]] * 2)
        np.testing.assert_array_equal(p.soc_kwh.numpy(), [[6, 8, 4]] * 2)
        assert p.it_kw.data_ptr() == ring.values.data_ptr()


# ---------------------------------------------------------------------------
# 3. the recompile detector, driven through kernels/build.py's hook
# ---------------------------------------------------------------------------

def _unit(built: bool):
    """One unit of work; `built`: it built a kernel library."""
    if built:
        tel.note_compile(0.25)


class TestRecompileDetector:
    def test_warns_on_per_cell_rebuilds(self):
        with pytest.warns(UserWarning, match="recompiled in"):
            with tel.recompile_guard("sweep", allowed=1,
                                     policy="warn") as g:
                for _ in range(4):
                    _unit(True)
                    g.tick()
        assert g.bursts == 4 and g.compiles == 4

    def test_raises_under_raise_policy(self):
        with pytest.raises(tel.RecompileError):
            with tel.recompile_guard("sweep", allowed=1,
                                     policy="raise") as g:
                for _ in range(3):
                    _unit(True)
                    g.tick()

    def test_ignore_policy_stays_quiet(self, recwarn):
        with tel.recompile_guard("sweep", allowed=0, policy="ignore") as g:
            _unit(True)
        assert g.bursts == 1
        assert not [w for w in recwarn.list
                    if "recompiled" in str(w.message)]

    def test_no_false_positive_when_only_the_first_unit_builds(self):
        with tel.recompile_guard("steady", allowed=1, policy="raise") as g:
            for i in range(5):
                _unit(i == 0)
                g.tick()
        assert g.bursts == 1

    def test_mark_leaves_out_builds_between_units(self):
        with tel.recompile_guard("marked", allowed=0, policy="raise") as g:
            for _ in range(3):
                _unit(True)  # outside the unit's window
                g.mark()
                g.tick()
        assert g.bursts == 0 and g.compiles == 3

    def test_policy_is_inherited_from_the_session(self, tmp_path):
        with tel.session(out_dir=str(tmp_path), export=False,
                         recompile_policy="raise"):
            assert tel.recompile_guard("x").policy == "raise"
        assert tel.recompile_guard("x").policy == "warn"
        with pytest.raises(ValueError):
            tel.RecompileGuard("x", policy="sometimes")

    def test_chunked_sweep_does_not_trip_the_guard(self, tmp_path, recwarn):
        caps = np.array([2.0, 4.0, 8.0, 16.0], np.float32)
        with tel.session(out_dir=str(tmp_path), export=False,
                         recompile_policy="raise"):
            P.sweep_grid(TASKS, HOSTS, _cfg(pconfig),
                         [P.dyn_axis(batt_capacity_kwh=caps)], CI,
                         chunk_size=2, device="cpu")
        assert not [w for w in recwarn.list
                    if "recompiled" in str(w.message)]

    def test_compile_watch_counts_the_build_hook(self, tmp_path,
                                                 monkeypatch):
        """kernels/build.py reports an `nvcc` build to the monitor (here a
        stand-in compiler that writes its output file)."""
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                        '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                        "  shift\ndone\n")
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
        with tel.compile_watch() as w:
            report = build.build_all(("fused_step", "first_fit"))
        assert set(report) == {"fused_step", "first_fit"}
        assert w.count == 2 and w.seconds >= 0.0
        with tel.compile_watch() as w:
            build.build_all(("fused_step",))   # built: nothing to do
        assert w.count == 0


# ---------------------------------------------------------------------------
# 4. run records
# ---------------------------------------------------------------------------

def _kinds(records) -> list:
    return [r.kind for r in records]


class TestRunRecords:
    def test_simulate_emits_the_references_record(self, tmp_path):
        jc, pc = _cfg(jconfig), _cfg(pconfig)
        with jtel.session(out_dir=str(tmp_path / "j"), export=False) as jt:
            _jrun(jc)
        with tel.session(out_dir=str(tmp_path / "p"), export=False) as t:
            _run(pc)
        assert _kinds(t.records) == _kinds(jt.records) == ["simulate"]
        rec, jrec = t.records[0], jt.records[0]
        assert rec.backend == jrec.backend == "stage-pipeline"
        assert rec.n_steps == jrec.n_steps == S
        assert rec.config_hash == jrec.config_hash == tel.config_hash(pc)
        assert rec.platform == "cpu" and rec.device_count == 1
        assert rec.devices == ["cpu"] and rec.plain_kernels is True
        assert rec.memory == [{"device": "cpu", "peak_bytes_in_use": None,
                               "bytes_in_use": None}]
        assert rec.compile_time_s >= 0.0 and rec.execute_time_s >= 0.0
        assert rec.probes is None

    def test_config_hashes_agree_with_the_reference(self):
        for kw in ({}, {"backend": "megakernel"},
                   {"probes": "ProbeConfig"}):
            jc, pc = [_cfg(C, cool=True, price=True, **(
                {"probes": C.ProbeConfig(enabled=True, stride=4)}
                if "probes" in kw else kw)) for C in (jconfig, pconfig)]
            assert repr(jc) == repr(pc)
            assert tel.config_hash(pc) == jtel.config_hash(jc)

    def test_probe_plan_lands_in_the_record(self, tmp_path):
        cfg = _cfg(pconfig, backend="megakernel",
                   probes=pconfig.ProbeConfig(enabled=True, stride=4,
                                              max_samples=10))
        with tel.session(out_dir=str(tmp_path), export=False) as t:
            _run(cfg)
        assert t.records[-1].probes == {"stride": 4, "capacity": 10}

    def test_chunked_grid_record_carries_the_chunk_plan(self, tmp_path):
        caps = np.array([2.0, 4.0, 8.0, 16.0], np.float32)
        jc, pc = _cfg(jconfig), _cfg(pconfig)
        with jtel.session(out_dir=str(tmp_path / "j"), export=False) as jt:
            J.sweep_grid(J_TASKS, J_HOSTS, jc,
                         [J.dyn_axis(batt_capacity_kwh=caps)], CI,
                         chunk_size=2)
        with tel.session(out_dir=str(tmp_path / "p"), export=False) as t:
            P.sweep_grid(TASKS, HOSTS, pc,
                         [P.dyn_axis(batt_capacity_kwh=caps)], CI,
                         chunk_size=2, device="cpu")
        assert _kinds(t.records) == _kinds(jt.records) == ["grid"]
        rec, jrec = t.records[0], jt.records[0]
        assert rec.grid_shape == jrec.grid_shape == [4]
        for key in ("chunk_size", "n_chunks", "auto"):
            assert rec.chunk[key] == jrec.chunk[key], key
        assert rec.chunk["chunk_size"] == 2 and rec.chunk["n_chunks"] == 2
        assert rec.chunk["auto"] is False
        assert rec.chunk["predicted_bytes_per_lead"] > 0
        assert rec.chunk["actual_payload_bytes"] == caps.nbytes
        assert rec.extra["n_scenarios"] == 4
        assert rec.extra["axes"] == jrec.extra["axes"]
        with open(os.path.join(str(tmp_path / "p"),
                               "run_records.jsonl")) as f:
            parsed = [tel.RunRecord.from_json(line) for line in f]
        assert any(dataclasses.asdict(p) == dataclasses.asdict(rec)
                   for p in parsed)

    def test_auto_chunked_grid_record(self, tmp_path):
        with tel.session(out_dir=str(tmp_path), export=False) as t:
            P.sweep_grid(TASKS, HOSTS, _cfg(pconfig),
                         [P.dyn_axis(batt_capacity_kwh=np.array(
                             [2.0, 4.0], np.float32))], CI, device="cpu")
        assert t.records[0].chunk["auto"] is True
        assert t.records[0].chunk["n_chunks"] == 1

    @pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
    def test_trace_dtype_recorded_per_axis(self, tmp_path, store):
        traces = np.stack([CI, CI * 0.5]).astype(np.float32)
        with jtel.session(out_dir=str(tmp_path / "j"), export=False) as jt:
            J.sweep_grid(J_TASKS, J_HOSTS, _cfg(jconfig),
                         [J.trace_axis(traces, store=store)])
        with tel.session(out_dir=str(tmp_path / "p"), export=False) as t:
            P.sweep_grid(TASKS, HOSTS, _cfg(pconfig),
                         [P.trace_axis(traces, store=store)], device="cpu")
        want = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}[store]
        assert t.records[0].trace_dtypes == {"ci_trace": want}
        assert jt.records[0].trace_dtypes == {"ci_trace": want}

    def test_fleet_emits_the_references_record(self, tmp_path):
        traces = np.stack([CI, CI[::-1]])
        with jtel.session(out_dir=str(tmp_path / "j"), export=False) as jt:
            J.simulate_fleet(J_TASKS, J_HOSTS, _cfg(jconfig, batt=False),
                             JFleetSpec(ci_traces=traces))
        with tel.session(out_dir=str(tmp_path / "p"), export=False) as t:
            P.simulate_fleet(TASKS, HOSTS, _cfg(pconfig, batt=False),
                             P.FleetSpec(ci_traces=traces), device="cpu")
        assert _kinds(t.records) == _kinds(jt.records) == ["fleet"]
        assert t.records[0].extra == {"n_regions": 2, "policy": "greedy"}
        assert t.records[0].extra == jt.records[0].extra

    def test_only_the_outermost_recorder_cuts_a_record(self, tmp_path):
        cfg = _cfg(pconfig)
        with tel.session(out_dir=str(tmp_path), export=False) as t:
            with tel.run_recorder("grid", cfg, device="cpu") as rec:
                _run(cfg)
                _run(cfg)
            _run(cfg)
        assert _kinds(t.records) == ["grid", "simulate"]
        assert rec.record is t.records[0]

    def test_memory_watermarks_on_the_cpu(self):
        assert tel.device_memory_watermarks() == [
            {"device": "cpu", "peak_bytes_in_use": None,
             "bytes_in_use": None}]
        assert tel.peak_bytes_per_device() is None


# ---------------------------------------------------------------------------
# 5. kernel 3's series entry on the CPU
# ---------------------------------------------------------------------------

def _chain_inputs(cfg, resil: bool):
    dyn = {"price_trace": PRICE, "wet_bulb_trace": WB, "pv_cf_trace": CF}
    x = P.build_step_inputs(CI, cfg, dyn, device="cpu")
    it = torch.from_numpy(np.random.default_rng(3).uniform(
        2.0, 12.0, S).astype(np.float32))
    args = (it, x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
            x.pv_cf, x.batt_threshold, x.ci_rising)
    return args, ({"chiller_derate": x.chiller_derate} if resil else {})


@pytest.mark.parametrize("resil", [False, True])
@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_ops_chain_on_the_cpu_is_the_plain_chain(resil, store):
    cfg = _cfg(pconfig, cool=True, price=True, renew=True,
               resilience=pconfig.ResilienceConfig(
                   enabled=resil, chiller_mtbf_h=8.0, chiller_repair_h=6.0))
    args, kw = _chain_inputs(cfg, resil)
    ops.reset_launch_counts()
    flows, totals = ops.fused_facility_chain(*args, cfg, trace_store=store,
                                             **kw)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    traces = [ref.stored_trace(args[i], store) if i in (1, 2, 3, 6)
              else a for i, a in enumerate(args)]
    want = ref.fused_facility_chain(*traces, cfg.dt_h, cfg, **kw)
    assert set(flows) == set(want) == {*fs.SERIES_FIELDS, "want_charge",
                                       "chiller_derate"}
    for k, v in want.items():
        assert torch.equal(flows[k], v), k
    echo = kw["chiller_derate"] if resil else torch.ones(S)
    assert torch.equal(flows["chiller_derate"], echo)
    if resil:
        assert bool((echo < 1.0).any())
    route = ops.fused_facility_totals(*args, cfg, trace_store=store, **kw)
    assert set(route) == set(totals)
    for k in route:
        assert torch.equal(route[k], totals[k]), k


@pytest.mark.parametrize("resil", [False, True])
def test_plain_chain_echo_matches_the_reference(resil):
    cfg_j, cfg_p = [_cfg(C, cool=True, price=True, renew=True,
                         resilience=C.ResilienceConfig(
                             enabled=resil, chiller_mtbf_h=8.0,
                             chiller_repair_h=6.0))
                    for C in (jconfig, pconfig)]
    args, kw = _chain_inputs(cfg_p, resil)
    got = ref.fused_facility_chain(*args, DT, cfg_p, **kw)
    want = jref.fused_facility_chain(
        *(jnp.asarray(a.numpy()) for a in args), DT, cfg_j,
        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    np.testing.assert_array_equal(got["chiller_derate"].numpy(),
                                  np.asarray(want["chiller_derate"]))


def test_port_probe_fields_are_the_references():
    assert tel.Probes._fields == jtel.Probes._fields
    assert tel.PROBE_VALUE_FIELDS == jtel.PROBE_VALUE_FIELDS
    for stride, cap in ((1, 0), (3, 0), (3, 10), (7, 200)):
        assert tel.probe_capacity(S, pconfig.ProbeConfig(
            True, stride, cap)) == jtel.probe_capacity(
            S, jconfig.ProbeConfig(True, stride, cap))
