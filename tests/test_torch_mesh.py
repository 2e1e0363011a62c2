"""The port's multi-GPU grid executors on gloo ranks, on the CPU.

`ScenarioGrid.run(mesh=)`, `run_shard_map`, a fleet grid and
`sharded_sweep` run on worlds of 1, 2 and 4 processes (gloo over a
`file://` store under the test's temporary directory; one `python` a rank,
as `torchrun` starts them).  Every rank's result must be the whole grid,
bit-equal to the port's own unsharded run of the same grid on the CPU, and
equal to the reference's unsharded `sweep_grid` under the reference's grid
contract (counts exact, rtol 1e-5, atol 1e-6; the reference's own sharded
executors fail on this tree).  At a world of one the mesh path is the
chunked path bit for bit.  The reference's ValueErrors hold word for word.
"""
from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.core.config as pconfig

torch.set_num_threads(1)

N_STEPS = 96
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "class_n_violations", "class_n_decided", "class_n_started")
CAPS = np.array([2.0, 6.0], np.float32)
FLEET_CAPS = np.array([1.0, 3.0, 5.0, 9.0], np.float32)


def _series(base, amp, phases):
    t = np.arange(N_STEPS) * 0.25
    return np.stack([base + amp * np.sin(2 * np.pi * t / 24.0 + p)
                     for p in phases]).astype(np.float32)


TRACES = _series(300.0, 200.0, (0.0, 1.7, 3.1, 4.4))


def _np_tables(core):
    rng = np.random.default_rng(0)
    n = 12
    tasks = core.make_task_table(np.sort(rng.uniform(0.0, 6.0, n)),
                                 rng.uniform(0.5, 4.0, n),
                                 rng.integers(1, 3, n).astype(float))
    return tasks, core.make_host_table(3, 4)


def port_tables():
    import repro.core as J
    jt, jh = _np_tables(J)
    as_np = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}  # noqa: E731,E501
    return P.tables_from_numpy(as_np(jt), as_np(jh), device="cpu")


def grid_case(core, C, name):
    """(cfg, axes) of one grid in either package."""
    battery = C.BatteryConfig(enabled=True)
    cfg = C.SimConfig(n_steps=N_STEPS, battery=battery)
    if name == "fleet":
        fleet = core.FleetSpec(ci_traces=TRACES[:2])
        return cfg, [core.dyn_axis(batt_capacity_kwh=FLEET_CAPS),
                     core.region_axis(fleet)]
    return cfg, [core.trace_axis(TRACES), core.dyn_axis(batt_capacity_kwh=CAPS)]


def run_case(core, C, tables, name, device=None, mesh=None):
    """The result of case `name`; `mesh=None` is the unsharded run."""
    kw = {} if device is None else {"device": device}
    tasks, hosts = tables
    cfg, axes = grid_case(core, C, "fleet" if name == "fleet" else "grid")
    if name == "sweep":
        if mesh is None:
            return core.sweep_regions(tasks, hosts, TRACES, cfg, **kw)
        return core.sharded_sweep(mesh, tasks, hosts, TRACES, cfg, **kw)
    if name == "shard_map":
        return core.sweep_grid(tasks, hosts, cfg, axes, mesh=mesh,
                               executor="shard_map" if mesh is not None
                               else "chunked", **kw)
    if name == "chunked_reduced":
        return core.sweep_grid(tasks, hosts, cfg, axes, mesh=mesh,
                               chunk_size=1, reduce=("min", 1), **kw)
    if name == "fleet" or name == "plain":
        return core.sweep_grid(tasks, hosts, cfg, axes, mesh=mesh, **kw)
    if name == "megakernel":
        return core.sweep_grid(tasks, hosts, cfg.replace(backend=name), axes,
                               mesh=mesh, **kw)
    raise ValueError(name)


CASES = ("plain", "chunked_reduced", "shard_map", "fleet", "sweep",
         "megakernel")


def flat(res) -> dict:
    """A (Fleet)SimResult as {field: numpy array}."""
    if hasattr(res, "per_region"):
        return {**{"total." + k: v for k, v in flat(res.total).items()},
                **{"per_region." + k: v
                   for k, v in flat(res.per_region).items()}}
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items() if v is not None}


def _worker(rank: int, world: int, store: str, out: str):
    """One rank: every case on its mesh, the results saved as numpy."""
    import repro_torch.core.telemetry as telemetry
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=world, rank=rank, store_dir=store)
    tables = port_tables()
    model = 2 if world == 4 else 1
    mesh = M.make_test_mesh(data=world // model, model=model,
                            device_type="cpu")
    got = {}
    with telemetry.session() as tel:
        for name in CASES:
            got[name] = flat(run_case(P, pconfig, tables, name, "cpu", mesh))
    recs = [r for r in tel.records if r.kind == "grid"]
    got["records"] = [{"mesh": r.mesh, "chunk": r.chunk,
                       "executor": r.extra.get("executor")} for r in recs]
    if world == 1:
        # the world-of-one mesh path against the chunked path
        got["chunked"] = flat(P.sweep_grid(
            *tables, *grid_case(P, pconfig, "grid"), chunk_size=1,
            device="cpu"))
        got["mesh_chunked"] = flat(P.sweep_grid(
            *tables, *grid_case(P, pconfig, "grid"), chunk_size=1,
            mesh=mesh, device="cpu"))
    else:
        # a leading axis the lead devices do not divide
        cfg, axes = grid_case(P, pconfig, "grid")
        odd = [P.trace_axis(TRACES[:3]), axes[1]]
        for kw in ({}, {"executor": "shard_map"}):
            try:
                P.sweep_grid(*tables, cfg, odd, mesh=mesh, device="cpu", **kw)
                got.setdefault("errors", []).append(None)
            except ValueError as e:
                got.setdefault("errors", []).append(str(e))
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    M.shutdown()


def _spawn(world: int, tmp_path) -> list[dict]:
    store, out = tmp_path / "store", tmp_path / "out"
    store.mkdir()
    out.mkdir()
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "..", "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, here, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_mesh as t; t._worker({r}, {world}, "
         f"{str(store)!r}, {str(out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    # every rank's pipes drained at once: a rank that fills a pipe no one
    # reads blocks, and the others then wait for it in a collective
    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(lambda p: p.communicate(timeout=240), procs))
    errs = [(p.returncode, err[-3000:]) for p, (_, err) in zip(procs, outs)]
    assert all(rc == 0 for rc, _ in errs), errs
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def unsharded():
    tables = port_tables()
    return {name: flat(run_case(P, pconfig, tables, name, "cpu"))
            for name in CASES}


@pytest.fixture(scope="module")
def reference():
    import repro.core as J
    import repro.core.config as jconfig
    tables = _np_tables(J)
    return {name: flat(run_case(J, jconfig, tables, name))
            for name in CASES}


def assert_bit_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (what, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


def assert_reference(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, v in want.items():
        g = np.asarray(got[k], np.float64)
        assert g.shape == v.shape, (what, k)
        if k.split(".")[-1] in COUNT_FIELDS:
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, np.asarray(v, np.float64),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_grids_equal_unsharded(world, tmp_path, unsharded, reference):
    ranks = _spawn(world, tmp_path)
    for r, got in enumerate(ranks):
        for name in CASES:
            assert_bit_equal(got[name], unsharded[name],
                             f"world {world} rank {r} {name}")
            assert_reference(got[name], reference[name], f"{name} vs ref")
    recs = ranks[0]["records"]
    shape = [world] if world < 4 else [2, 2]
    names = ["data", "model"]
    # plain, chunked_reduced, shard_map, fleet, sweep, megakernel: a grid
    # record each
    assert len(recs) == 6
    assert all(r["mesh"] == {"axis_names": names,
                             "shape": [world // (2 if world == 4 else 1),
                                       2 if world == 4 else 1]}
               for r in recs), recs
    ndev = world // (2 if world == 4 else 1)
    assert recs[0]["chunk"]["chunk_size"] == 4          # unchunked
    assert recs[1]["chunk"]["chunk_size"] == ndev       # 1 rounded up
    assert recs[2]["executor"] == "shard_map"
    assert recs[2]["chunk"]["chunk_size"] == 4 // ndev
    assert recs[2]["chunk"]["n_chunks"] == ndev
    del shape
    if world == 1:
        assert_bit_equal(ranks[0]["mesh_chunked"], ranks[0]["chunked"],
                         "world of one against the chunked path")
    else:
        assert ranks[0]["errors"][0] is not None
        assert "k * devices" in ranks[0]["errors"][0]
        assert "divide evenly" in ranks[0]["errors"][1]


def test_executor_value_errors():
    """The reference's ValueErrors, word for word, without a mesh."""
    tasks, hosts = port_tables()
    cfg, axes = grid_case(P, pconfig, "grid")
    with pytest.raises(ValueError, match="one chunk per device"):
        P.sweep_grid(tasks, hosts, cfg, axes, executor="shard_map",
                     chunk_size=2, device="cpu")
    with pytest.raises(ValueError, match="one chunk per device"):
        P.sweep_grid(tasks, hosts, cfg, axes, executor="shard_map",
                     reduce=("min", 1), device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        P.sweep_grid(tasks, hosts, cfg, axes, executor="pmap", device="cpu")
    fleet = P.FleetSpec(ci_traces=TRACES[:2])
    with pytest.raises(ValueError, match="only axis is the region_axis"):
        P.sweep_grid(tasks, hosts, cfg, [P.region_axis(fleet)],
                     mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="leading axis is the region_axis"):
        P.ScenarioGrid([P.region_axis(fleet)]).shard_map_callable(
            tasks, hosts, cfg, device="cpu")


def test_shard_map_without_a_group_is_the_unchunked_run(unsharded):
    """No process group: `run_shard_map` is one block, the whole grid."""
    tasks, hosts = port_tables()
    cfg, axes = grid_case(P, pconfig, "grid")
    grid = P.ScenarioGrid(axes)
    got = flat(grid.run_shard_map(tasks, hosts, cfg, device="cpu"))
    assert_bit_equal(got, unsharded["plain"], "shard_map, no group")
    call = grid.shard_map_callable(tasks, hosts, cfg, donate=False,
                                   device="cpu")
    pay = grid.payloads()
    for _ in range(2):
        assert_bit_equal(flat(call(*pay)), unsharded["plain"], "callable")


@pytest.mark.parametrize("backend", ["stage-pipeline", "megakernel"])
def test_rows_do_not_depend_on_the_rows_beside_them(backend):
    """A cell's fields are the same bits whatever the number of rows run
    beside it (chunks of 1, 2 and 4 points against the whole grid), as
    the reference pins its chunked grid to the unchunked one: what a
    mesh's blocks rely on.  (The megakernel's totals once summed strided
    step series, whose order on the CPU changes with the row count.)"""
    tasks, hosts = port_tables()
    cfg, axes = grid_case(P, pconfig, "grid")
    cfg = cfg.replace(backend=backend)
    want = flat(P.sweep_grid(tasks, hosts, cfg, axes, device="cpu"))
    for chunk in (1, 2, 3):
        got = flat(P.sweep_grid(tasks, hosts, cfg, axes, chunk_size=chunk,
                                device="cpu"))
        assert_bit_equal(got, want, f"{backend}, chunks of {chunk}")
