"""The plain versions of the port's four kernels against the reference ops.

Each plain PyTorch version (repro_torch/kernels/ref.py, what the port runs
on the CPU and what the card's kernels are held to) meets the reference
package's Pallas op in interpret mode on the same numpy inputs, at the
shapes of tests/test_kernels.py and tests/test_megakernel.py:

  * per-host power rtol 1e-5, atol 1e-6; IT sum, carbon, cooling and water
    rtol 1e-4 (sums reassociate);
  * first-fit: assignments equal, free vectors atol 1e-5;
  * facility totals: rtol 1e-4, atol 1e-3 with f32 traces; with bf16 and
    int8 stores the decision-free energy totals stay within 5e-3 and 1e-2
    relative of the f32 chain (battery off: quantized carbon intensity can
    flip dispatch decisions).

tests/test_torch_card.py holds each hand-written kernel to its plain
version on the card at the same tolerances.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.kernels import ops as jops
from repro.kernels.fused_step import fused_facility_totals as j_fused_totals
import repro_torch.core.config as pconfig
from repro_torch.core import scheduler as pscheduler
from repro_torch.core import state as pstate
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import first_fit as ff
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import host_sum as hs
from repro_torch.kernels import power_carbon as pc

torch.set_num_threads(1)

S = 96
DT = 0.25
T = torch.tensor


def _host_inputs(h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, h).astype(np.float32),
            rng.uniform(0, 1, h).astype(np.float32),
            rng.integers(0, 4, h).astype(np.float32),
            (rng.uniform(size=h) < 0.8).astype(np.float32))


@pytest.mark.parametrize("h", [7, 128, 1000, 2048])
@pytest.mark.parametrize("curves", [("sqrt", "linear"), ("square", "cubic")])
def test_power_carbon_plain_matches_reference(h, curves):
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h)
    want = jops.fused_power_carbon(
        cpu_u, gpu_u, ngpu, on, 350.0, 0.25,
        jconfig.PowerModelConfig(80.0, 250.0, curves[0]),
        jconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    got = ops.fused_power_carbon(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(350.0), 0.25,
        pconfig.PowerModelConfig(80.0, 250.0, curves[0]),
        pconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    p, it = ops.host_power(T(cpu_u), T(gpu_u), T(ngpu), T(on),
                           pconfig.PowerModelConfig(80.0, 250.0, curves[0]),
                           pconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    np.testing.assert_array_equal(p.numpy(), got[0].numpy())
    np.testing.assert_array_equal(it.numpy(), got[1].numpy())


@pytest.mark.parametrize("h", [7, 128, 1000, 2048])
@pytest.mark.parametrize("wb,sp", [(30.0, 24.0), (10.0, 24.0), (21.0, 24.0),
                                   (25.0, 18.0)])
def test_facility_power_plain_matches_reference(h, wb, sp):
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h + int(wb))
    args = [jconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
            jconfig.PowerModelConfig(40.0, 300.0, "linear"),
            jconfig.CoolingConfig(enabled=True)]
    want = jops.facility_power(cpu_u, gpu_u, ngpu, on, wb, sp, *args)
    got = ops.facility_power(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(wb), T(sp),
        pconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        pconfig.PowerModelConfig(40.0, 300.0, "linear"),
        pconfig.CoolingConfig(enabled=True))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("r,h", [(1, 7), (4, 128), (3, 1000)])
def test_facility_power_rows_match_reference_batched(r, h):
    """[B, H] scenario rows == the reference's vmapped batched op."""
    rng = np.random.default_rng(r * h)
    cpu_u, gpu_u = (rng.uniform(0, 1, (r, h)).astype(np.float32)
                    for _ in range(2))
    ngpu = rng.integers(0, 4, (r, h)).astype(np.float32)
    on = (rng.uniform(size=(r, h)) < 0.8).astype(np.float32)
    wb = rng.uniform(5.0, 35.0, r).astype(np.float32)
    sp = rng.uniform(18.0, 28.0, r).astype(np.float32)
    want = jops.facility_power_batched(
        cpu_u, gpu_u, ngpu, on, wb, sp,
        jconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        jconfig.PowerModelConfig(40.0, 300.0, "linear"),
        jconfig.CoolingConfig(enabled=True))
    got = ops.facility_power(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(wb), T(sp),
        pconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        pconfig.PowerModelConfig(40.0, 300.0, "linear"),
        pconfig.CoolingConfig(enabled=True))
    assert got[0].shape == (r, h) and got[1].shape == (r,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def _ff_inputs(k, h, seed, live=None):
    rng = np.random.default_rng(seed)
    cc = rng.integers(1, 8, k).astype(np.float32)
    cg = rng.integers(0, 2, k).astype(np.float32)
    fc = rng.integers(0, 16, h).astype(np.float32)
    fg = rng.integers(0, 4, h).astype(np.float32)
    if live is not None:  # the scheduler's inert tail and unusable hosts
        cc[live:] = cg[live:] = np.inf
        down = rng.uniform(size=h) < 0.2
        fc[down] = fg[down] = -np.inf
    return cc, cg, fc, fg


@pytest.mark.parametrize("live", [None, "half"])
@pytest.mark.parametrize("k,h", [(4, 3), (16, 64), (64, 300), (64, 972)])
def test_first_fit_plain_matches_reference(k, h, live):
    args = _ff_inputs(k, h, k * h, None if live is None else k // 2)
    want = jops.first_fit_place(*args)
    got = ops.first_fit_place(*(T(x) for x in args))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_first_fit_rows_are_independent():
    rows = [_ff_inputs(16, 64, s, 10) for s in range(3)]
    stacked = [T(np.stack(x)) for x in zip(*rows)]
    got = ops.first_fit_place(*stacked)
    for i, row in enumerate(rows):
        one = ops.first_fit_place(*(T(x) for x in row))
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[i].numpy(), w.numpy())


# ---------------------------------------------------------------------------
# first-fit's warp layout (csrc/first_fit.cu, first_fit_warp_kernel)
# ---------------------------------------------------------------------------

def test_first_fit_variant_follows_host_count():
    """The wrapper picks the kernel from H alone: one warp a row while the
    row fits 32 lanes of HOSTS_PER_LANE hosts, one block a row beyond."""
    assert ff.WARP_MAX_HOSTS == 32 * ff.HOSTS_PER_LANE == 1024
    assert [ff.variant(h) for h in (1, 31, 32, 972, 1024)] == ["warp"] * 5
    assert [ff.variant(h) for h in (1025, 2048, ff.MAX_HOSTS)] == \
        ["block"] * 3
    assert ff.warp_grid(1) == (1, 128) and ff.warp_grid(5) == (2, 128)


def _lanes_first_fit(cc, cg, fc, fg):
    """The warp kernel's placement, written out in torch: the H hosts padded
    with -inf to 32 lanes x R, lane l holding hosts l*R .. l*R+R-1; per live
    candidate each lane's lowest fitting local index, the min over lanes of
    lane * R + index, and one subtraction in the owning lane's slot."""
    r = ff.HOSTS_PER_LANE
    h = fc.shape[0]
    pad = torch.full((32 * r - h,), -np.inf)
    lc = torch.cat([fc, pad]).reshape(32, r)
    lg = torch.cat([fg, pad]).reshape(32, r)
    slot = torch.arange(r)
    none = 2 ** 32 - 1                     # the kernel's "no fit" (u32 max)
    assign = torch.full(cc.shape, -1, dtype=torch.int32)
    for j in range(cc.shape[0]):
        need_c, need_g = cc[j], cg[j]
        if need_c == np.inf or need_g == np.inf:
            continue                       # inert slot
        fits = (lc >= need_c) & (lg >= need_g)
        first_in_lane = torch.where(fits, slot, r).amin(1)
        lane_first = torch.where(first_in_lane < r,
                                 torch.arange(32) * r + first_in_lane, none)
        first = int(lane_first.min())
        if first < h:
            lane, s = divmod(first, r)
            lc[lane, s] -= need_c
            lg[lane, s] -= need_g
            assign[j] = first
    return assign, lc.reshape(-1)[:h], lg.reshape(-1)[:h]


@pytest.mark.parametrize("case", ["live", "inert", "down"])
@pytest.mark.parametrize("k,h", [(4, 3), (64, 31), (40, 100), (100, 972),
                                 (64, 1024)])
def test_first_fit_lane_layout_matches_plain_and_reference(k, h, case):
    """The lane layout places exactly as the sequential plain version and
    the reference's Pallas op (interpret mode): assignments equal, free
    vectors bit for bit, on inputs with many ties, H not a multiple of 32,
    -inf (down) hosts and +inf (inert) slots."""
    cc, cg, fc, fg = _ff_inputs(k, h, k + h, None if case == "live"
                                else k // 2)
    if case == "down":
        fc[:] = fg[:] = -np.inf
    got = _lanes_first_fit(*(T(x) for x in (cc, cg, fc, fg)))
    for want in (ops.first_fit_place(*(T(x) for x in (cc, cg, fc, fg))),
                 [T(np.asarray(x)) for x in
                  jops.first_fit_place(cc, cg, fc, fg)]):
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.numpy().view(np.int32))
    if case == "down":
        assert bool((got[0] == -1).all())


@pytest.mark.parametrize("h", [1, 31, 972, 1024, 1025, 2048, 4096, 5000])
def test_facility_block_covers_the_row(h):
    """Facility power's block: one host a thread, a multiple of 32 threads,
    at most 1024; one pass covers the row up to 1024 hosts (the kernel
    loops past that)."""
    threads = pc.facility_block(h)
    assert threads % 32 == 0 and 32 <= threads <= pc.MAX_THREADS
    assert min(h, pc.MAX_THREADS) <= threads < min(h, pc.MAX_THREADS) + 32


class _Launch:
    """Stands in for a C entry point on the CPU: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _host_sum_workspace(b, t):
    """Stands in for the kernel library's workspace size on the CPU: any
    size, not a multiple of 4 bytes."""
    return 1000 * b + 3 * t + 2


@pytest.fixture
def recorded_launch(monkeypatch):
    """The wrappers' launch path with the C entry points recorded instead
    of called (no card here): returns the recorder."""
    fn = _Launch()
    monkeypatch.setattr(build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(build, "function", lambda *a: fn)
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    # the per-host sums' workspace is laid out by the kernel's library
    monkeypatch.setattr(hs, "workspace_bytes", _host_sum_workspace)
    yield fn
    ops.reset_launch_counts()


@pytest.mark.parametrize("h", [7, 972, 1024, 1025, 5000])
def test_power_carbon_launches_the_row_pass_block(recorded_launch, h):
    """Kernel 1 takes the row pass's block, one host a thread, as facility
    power does; the megakernel's call passes no carbon intensity."""
    cpu_u, gpu_u, ngpu, on = (T(x) for x in _host_inputs(h, h))
    cfg = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, None, 0.25, cfg, cfg)
    pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, T(350.0), 0.25, cfg, cfg)
    without, with_ci = recorded_launch.calls
    assert without[4] is None and with_ci[4] is not None
    for args in recorded_launch.calls:
        assert args[6:9] == (1, h, pc.facility_block(h))


def _host_cols(b, t, h, seed, shared="row"):
    """Task columns as the scheduler hands them: status and host [B, T] (or
    [T] for b = 0), values and weights [T] (`shared="flat"`), [1, T]
    ("row") or [B, T] ("own")."""
    rng = np.random.default_rng(seed)
    shape = (b, t) if b else (t,)
    status = T(np.where(rng.uniform(size=shape) < 0.3, 1, 0).astype(np.int32))
    host = T(rng.integers(-1, h + 3, shape).astype(np.int32))
    vshape = {"flat": (t,), "row": (1, t), "own": shape}[shared if b else
                                                         "flat"]
    vals = [T(rng.choice(np.float32([4, 8, 16, 32, 48]), vshape))
            for _ in range(2)]
    weights = [T(rng.uniform(size=vshape).astype(np.float32))
               for _ in range(2)]
    return status, host, vals, weights


@pytest.mark.parametrize("shape", [(50,), (3, 50), (3, 0), (1, 50),
                                   (64, 9000)])
@pytest.mark.parametrize("shared", ["flat", "row", "own"])
@pytest.mark.parametrize("weighted", [False, True])
def test_host_sum_launch_passes_its_rows(recorded_launch, shape, shared,
                                         weighted):
    """The per-host sum wrapper hands the kernel the columns themselves
    (their data pointers, no copy), each with its row stride (0 for a [T]
    or [1, T] column shared by the rows), B, T, H and the RUNNING code, a
    workspace of the size the kernel's library asks for (whole int32s),
    the ticket counters and one [2, ..., H] output; it counts one
    launch."""
    h = 17
    b = shape[0] if len(shape) == 2 else 0
    status, host, vals, weights = _host_cols(b, shape[-1], h, 3, shared)
    ws = weights if weighted else [None, None]
    ops.reset_launch_counts()
    out = hs.per_host_sum(status, host, *vals, h, *ws)
    (args,) = recorded_launch.calls
    cols = (status, host, *vals, *ws)
    assert args[:6] == tuple(None if x is None else x.data_ptr()
                             for x in cols)
    assert args[6:12] == tuple(
        x.stride(0) if x is not None and x.dim() == 2 and x.shape[0] > 1
        else 0 for x in cols)
    rows = max(1, b)
    assert args[12:16] == (rows, shape[-1], h, pstate.RUNNING)
    need = _host_sum_workspace(rows, shape[-1])
    assert args[17] == -(-need // 4) * 4 and args[16] % 16 == 0
    lead = (rows,) if len(shape) == 2 else ()
    assert len(out) == 2 and all(o.shape == (*lead, h) for o in out)
    assert args[19] == out[0].data_ptr()
    assert args[20] - args[19] == 4 * out[0].numel()
    assert ops.launch_counts()["per_host_sum"] == 1


def test_host_sum_wrapper_refuses_what_the_kernel_cannot_take(
        recorded_launch):
    status = torch.ones((2, 8), dtype=torch.int32)
    host = torch.zeros((2, 8), dtype=torch.int32)
    vals = torch.ones((2, 8))
    with pytest.raises(ValueError, match="one T and one B"):
        hs.per_host_sum(status, host, vals, torch.ones(7), 4)
    with pytest.raises(ValueError, match="one T and one B"):
        hs.per_host_sum(status, host, vals, torch.ones((3, 8)), 4)
    with pytest.raises(ValueError, match="one T and one B"):
        hs.per_host_sum(status, host[:, :4], vals, vals, 4)
    with pytest.raises(ValueError, match="one T and one B"):
        hs.per_host_sum(status, host, vals, vals, 4, torch.ones((2, 2, 8)))
    with pytest.raises(ValueError, match="int32"):
        hs.per_host_sum(status.long(), host, vals, vals, 4)
    with pytest.raises(ValueError, match="int32"):
        hs.per_host_sum(status, host.long(), vals, vals, 4)
    with pytest.raises(ValueError, match="float32"):
        hs.per_host_sum(status, host, vals.double(), vals, 4)
    with pytest.raises(ValueError, match="hosts"):
        hs.per_host_sum(status, host, vals, vals, hs.MAX_HOSTS + 1)
    with pytest.raises(ValueError, match="hosts"):
        hs.per_host_sum(status, host, vals, vals, 0)
    with pytest.raises(ValueError, match="rows"):
        hs.per_host_sum(*(x.expand(hs.MAX_ROWS + 1, 8) for x in (
            status[:1], host[:1], vals[:1], vals[:1])), 4)
    # the host count bounds no buffer (at least the 17,132 hosts of the
    # first kernel)
    assert hs.MAX_HOSTS >= 17132
    assert not recorded_launch.calls


def _stable_bucket_sort(key, threads):
    """Phase 1's counting sort of one tile's n records by bucket, round by
    round: warp w takes records [w * span, (w + 1) * span) (span a
    multiple of 32), counts per (warp, bucket), a bucket-major prefix over
    the warps, ranks within a round of 32.  Returns (order, bucket starts
    [threads + 1])."""
    n = len(key)
    span = -(-n // threads) * 32
    nw = -(-n // span) if n else 0
    wcnt = np.zeros((max(nw, 1), threads), np.int64)
    for w in range(nw):
        np.add.at(wcnt[w], key[w * span:min((w + 1) * span, n)], 1)
    starts = np.concatenate([[0], np.cumsum(wcnt.sum(0))])
    base = (starts[:-1] + np.cumsum(wcnt, 0) - wcnt)  # [warp, bucket]
    perm = np.full(n, -1)
    for w in range(nw):
        for e0 in range(w * span, min(n, (w + 1) * span), 32):
            e = np.arange(e0, min(e0 + 32, n))
            for lane, ee in enumerate(e):
                k = key[ee]
                perm[base[w, k] + np.sum(key[e[:lane]] == k)] = ee
            for k in np.unique(key[e]):
                base[w, k] += np.sum(key[e] == k)
    assert sorted(perm) == list(range(n))
    return perm, starts


# csrc/host_sum.cu's kTile and kThreads (= kBuckets)
HOST_SUM_TILE, HOST_SUM_THREADS = 4096, 512


def _host_sum_rendering(status, host, a0, a1, h, w0, w1, tile=HOST_SUM_TILE,
                        threads=HOST_SUM_THREADS):
    """csrc/host_sum.cu's two phases in numpy: phase 1 compacts each tile's
    running tasks in task order and sorts them stably by bucket (host mod
    `threads`) into the tile's slot, with the bucket starts; in phase 2
    thread j walks bucket j through the tiles in order, adding in f32 onto
    the hosts' accumulators (threads run side by side: their hosts
    differ)."""
    cols = [np.atleast_2d(np.asarray(x)) for x in (status, host, a0, a1)]
    ws = [None if w is None else np.atleast_2d(np.asarray(w))
          for w in (w0, w1)]
    b = max(x.shape[0] for x in cols + [w for w in ws if w is not None])
    t = cols[0].shape[-1]
    out = np.zeros((2, b, h), np.float32)
    for r in range(b):
        st, ho, x0, x1 = (x[min(r, x.shape[0] - 1)] for x in cols)
        vals = [x if w is None else x * w[min(r, w.shape[0] - 1)]
                for x, w in zip((x0, x1), ws)]
        slots, bounds = [], []
        for i in range(max(1, -(-t // tile))):    # phase 1
            idx = np.arange(i * tile, min((i + 1) * tile, t))
            sel = idx[(st[idx] == pstate.RUNNING) & (ho[idx] >= 0)]
            rec = (np.minimum(ho[sel], h - 1), vals[0][sel], vals[1][sel])
            perm, starts = _stable_bucket_sort(rec[0] % threads, threads)
            slots.append([x[perm] for x in rec])
            bounds.append(starts)
        for j in range(threads):                  # phase 2, thread j
            for (hh, v0, v1), starts in zip(slots, bounds):
                for q in range(starts[j], starts[j + 1]):
                    assert hh[q] % threads == j
                    for c, v in enumerate((v0, v1)):
                        out[c, r, hh[q]] = np.float32(out[c, r, hh[q]] + v[q])
    return out if np.ndim(status) == 2 else out[:, 0]


@pytest.mark.parametrize("b,t,h,running,small", [
    (0, 9000, 972, 0.03, False), (2, 9000, 3, 1.0, False),
    (3, 6000, 1100, 0.5, False), (1, 0, 17, 1.0, False),
    (2, 9000, 5, 0.6, True), (0, 9000, 100, 0.3, True)])
def test_host_sum_rendering_gives_the_plain_bits(b, t, h, running, small):
    """The kernel's design gives the plain version's bits: tiles sorted by
    bucket (H above the bucket count, several hosts a bucket; every task
    running on 3 hosts, long chains), T = 0; with small constants (tiles of
    128, 64 threads and buckets) a row has 71 tiles and a warp's span of a
    tile more than one round.  Weighted and unweighted channels, a [1, T]
    value row."""
    rng = np.random.default_rng(t + h)
    shape = (b, t) if b else (t,)
    status = np.where(rng.uniform(size=shape) < running, pstate.RUNNING,
                      pstate.PENDING).astype(np.int32)
    host = rng.integers(-1, h + 2, shape).astype(np.int32)
    a0 = rng.choice(np.float32([4, 8, 16, 32, 48]), (1, t) if b else (t,))
    a1 = rng.integers(0, 5, shape).astype(np.float32)
    w0 = rng.uniform(size=shape).astype(np.float32)
    consts = dict(tile=128, threads=64) if small else {}
    got = _host_sum_rendering(status, host, a0, a1, h, w0, None, **consts)
    want = ref.per_host_sum(T(status), T(host), T(a0), T(a1), h, T(w0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


@pytest.mark.parametrize("fn", ["free_capacity", "host_utilization"])
@pytest.mark.parametrize("cells,written", [(0, False), (1, False),
                                           (4, False), (4, True)])
def test_scheduler_hands_the_launch_its_table_columns(
        recorded_launch, monkeypatch, fn, cells, written):
    """`free_capacity` and `host_utilization` make one launch a call on
    the task table's own columns (data pointers equal: no mask, bin or
    masked column is built, nothing is copied); a shared [1, T] column,
    and `cell_tables`' [B, T] views of one written row, pass with row
    stride 0; before the launch only its output and workspace are
    allocated (no eager op runs).  The CPU's route is swapped for the
    card's so the recorded launch sees the call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(ops, "ref", SimpleNamespace(
        per_host_sum=hs.per_host_sum))
    rng = np.random.default_rng(cells)
    t, h = 300, 40
    tasks = pstate.make_task_table(
        rng.uniform(0, 10, t), rng.uniform(1, 5, t),
        rng.choice([4.0, 8.0], t), gpus=rng.integers(0, 3, t),
        cpu_util=rng.uniform(size=t), device="cpu")
    tasks = tasks._replace(
        status=T(rng.integers(0, 3, t).astype(np.int32)),
        host=T(rng.integers(-1, h, t).astype(np.int32)))
    hosts = pstate.make_host_table(h, 48, 4, device="cpu")
    if cells:
        tasks, hosts = pstate.cell_tables(tasks, hosts, cells)
        if written:  # a step has written the rows
            tasks = tasks._replace(status=tasks.status.clone(),
                                   host=tasks.host.clone())
    getattr(pscheduler, fn)(tasks, hosts)  # the ticket counters, once
    recorded_launch.calls.clear()
    ops.reset_launch_counts()
    seen = []
    monkeypatch.setattr(build, "function", lambda *a: lambda *args: (
        seen.append("launch"), recorded_launch(*args))[1])
    with Ops():
        getattr(pscheduler, fn)(tasks, hosts)
    (args,) = recorded_launch.calls
    assert ops.launch_counts()["per_host_sum"] == 1
    cols = [tasks.status, tasks.host, tasks.cores, tasks.gpus]
    cols += ([tasks.cpu_util, tasks.gpu_util] if fn == "host_utilization"
             else [None, None])
    assert args[:6] == tuple(None if x is None else x.data_ptr()
                             for x in cols)
    want = [0] * 6
    if cells > 1 and written:
        want[:2] = [t, t]
    assert list(args[6:12]) == want
    assert args[12:15] == (max(cells, 1), t, h)
    before = seen[:seen.index("launch")]
    assert before and set(before) == {"empty"}, before


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 255, 1023, 1024, 1025, 2880,
                               35040, 35041, 105120, 10 ** 6])
def test_facility_launch_plan_covers_the_horizon(s):
    """Kernel 3's tiles: a multiple of 32 steps, at most TILE_MAX, no longer
    than the horizon needs; ceil(S / tile) of them cover S with the last one
    partial; their ring fits a block's shared memory."""
    tile, n_tiles, smem = fs.launch_plan(s)
    assert tile % 32 == 0 and 32 <= tile <= fs.TILE_MAX
    assert tile == min(fs.TILE_MAX, max(32, -(-s // 32) * 32))
    assert n_tiles * tile >= s and (n_tiles == 0 or (n_tiles - 1) * tile < s)
    # a block may take 227 KB of an H100 SM's 228 KB; two of the largest
    # plan fit on one SM
    assert smem == fs.smem_bytes(tile) <= 227 * 1024
    assert 2 * fs.smem_bytes(fs.TILE_MAX) <= 228 * 1024


@pytest.mark.parametrize("s", [1, 255, 2880])
def test_facility_launch_passes_the_plan(recorded_launch, s):
    """The launch carries its plan's tile in the config block (the C entry
    point sizes shared memory from it) and returns a row of N_ACC lanes."""
    rng = np.random.default_rng(s)
    x = [T(rng.uniform(lo, hi, s).astype(np.float32)) for lo, hi in (
        (20, 80), (50, 600), (5, 25), (0.05, 0.2), (0.04, 0.1), (0.1, 0.3),
        (0, 1), (50, 600))] + [T(rng.uniform(size=s) < 0.5)]
    cfg = _cfg(pconfig, True, True, True, "blended")
    acc = fs.launch(*fs.prepare(*x, cfg))
    (args,) = recorded_launch.calls
    assert len(args) == 16
    fcfg, store, b = args[11]._obj, args[12], args[13]
    assert (fcfg.n_steps, fcfg.tile, store, b) == (s, fs.launch_plan(s)[0],
                                                   0, 1)
    assert acc.shape == (1, fs.N_ACC) == (1, fs.A_CUR + 1)


@pytest.mark.parametrize("pricing", [False, True])
@pytest.mark.parametrize("renewables", [False, True])
def test_facility_rows_map_to_the_totals(pricing, renewables):
    """Each total reads its own accumulator lane (times the step where it is
    an energy)."""
    cfg = _cfg(pconfig, True, pricing, renewables, "carbon")
    acc = torch.arange(1, 2 * fs.N_ACC + 1, dtype=torch.float32).reshape(
        2, fs.N_ACC)
    got = fs.totals_from_rows(acc, cfg)
    want = ref.fused_facility_totals(
        *[torch.ones(8)] * 8, torch.ones(8, dtype=torch.bool), cfg)
    assert set(got) == set(want)
    dt = np.float32(cfg.dt_h)
    lanes = {"soc_final": fs.A_SOC, "peak_power": fs.A_GRID_MAX,
             "grid_energy": fs.A_GRID, "it_energy": fs.A_IT,
             "batt_discharged": fs.A_DK, "curtailed_energy": fs.A_CUR}
    if pricing:
        lanes.update(demand_cost=fs.A_DEMAND, window_peak_kw=fs.A_WPEAK)
    for key, lane in lanes.items():
        scale = 1.0 if key in ("soc_final", "peak_power", "demand_cost",
                               "window_peak_kw") else dt
        torch.testing.assert_close(got[key], acc[:, lane] * scale)


def test_power_params_are_built_once_per_configuration():
    cpu = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    gpu = pconfig.PowerModelConfig(40.0, 300.0, "linear")
    cool = pconfig.CoolingConfig(enabled=True)
    same = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    assert pc._power_params(cpu, gpu) is pc._power_params(same, gpu)
    assert pc._cooling_params(cool) is pc._cooling_params(
        pconfig.CoolingConfig(enabled=True))
    with pytest.raises(ValueError, match="unknown power model"):
        pc._power_params(pconfig.PowerModelConfig(1.0, 2.0, "quartic"), gpu)


def test_build_reads_registers_and_spills_from_ptxas():
    lines = [
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "first_fit_warp_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121"
        "first_fit_warp_kernelEPKf",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "first_fit_kernelEPKf' for 'sm_90a'",
        "8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 26 registers, used 1 barriers"]
    warp = build.resources(lines, "first_fit_warp_kernel")
    assert warp == [{"function": "_ZN12_GLOBAL__N_121first_fit_warp_kernel"
                                 "EPKf", "stack": 0, "spill_stores": 0,
                     "spill_loads": 0, "registers": 96}]
    block = build.resources(lines, "first_fit_kernel")
    assert [(b["spill_stores"], b["spill_loads"], b["registers"])
            for b in block] == [(4, 8, 26)]


# ---------------------------------------------------------------------------
# the fused facility kernel's plain version (tests/test_megakernel.py shapes)
# ---------------------------------------------------------------------------

def _traces(seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(S) * DT
    ci = (rng.uniform(50, 600)
          * (1 + rng.uniform(0, 0.8) * np.sin(2 * np.pi * t / 24
                                              + rng.uniform(0, 6)))
          + rng.normal(0, 10, S)).clip(5.0).astype(np.float32)
    price = (rng.uniform(0.05, 0.2)
             * (1 + rng.uniform(0, 0.9) * np.sin(2 * np.pi * t / 24
                                                 + rng.uniform(0, 6)))
             + rng.exponential(0.01, S)).clip(0.005).astype(np.float32)
    wb = (rng.uniform(5, 25)
          + 6.0 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    day = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0)
    cf = (day * rng.uniform(0.3, 0.9)).astype(np.float32)
    return ci, price, wb, cf


CI, PRICE, WB, CF = _traces(7)
IT_KW = np.random.default_rng(3).uniform(20.0, 80.0, S).astype(np.float32)
COMBOS = [(cool, price, renew)
          for cool in (False, True)
          for price in (False, True)
          for renew in (False, True)]


def _cfg(C, cool, price, renew, policy="carbon", batt=True):
    return C.SimConfig(
        n_steps=S,
        cooling=C.CoolingConfig(enabled=cool, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=price, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=renew, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=batt, capacity_kwh=6.0,
                                policy=policy, price_window_h=24.0))


def _dyn(cfg):
    d = {}
    if cfg.pricing.enabled:
        d["price_trace"] = PRICE
    if cfg.cooling.enabled:
        d["wet_bulb_trace"] = WB
    if cfg.renewables.enabled:
        d["pv_cf_trace"] = CF
    return d


def _port_totals(cfg, store="f32"):
    from repro_torch.core.engine import build_step_inputs
    x = build_step_inputs(CI, cfg, _dyn(cfg), device="cpu")
    return ops.fused_facility_totals(
        T(IT_KW), x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
        x.pv_cf, x.batt_threshold, x.ci_rising, cfg, trace_store=store)


@pytest.mark.parametrize("cool,price,renew", COMBOS)
def test_facility_totals_plain_matches_reference_f32(cool, price, renew):
    policy = "blended" if price else "carbon"
    jcfg = _cfg(jconfig, cool, price, renew, policy)
    x = J.build_step_inputs(CI, jcfg, {k: jnp.asarray(v) for k, v in
                                       _dyn(jcfg).items()})
    want = j_fused_totals(
        jnp.asarray(IT_KW), x.ci, x.wet_bulb_c, x.price, x.price_lo,
        x.price_hi, x.pv_cf, x.batt_threshold, x.ci_rising, jcfg,
        trace_store="f32", interpret=True)
    got = _port_totals(_cfg(pconfig, cool, price, renew, policy))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]),
                                   rtol=1e-4, atol=1e-3,
                                   err_msg=f"facility total {k}")


@pytest.mark.parametrize("store,rel", [("bf16", 5e-3), ("int8", 1e-2)])
def test_facility_totals_quantized_stores(store, rel):
    cfg = _cfg(pconfig, True, True, True, batt=False)
    base = _port_totals(cfg)
    got = _port_totals(cfg, store)
    for k in ("grid_energy", "it_energy", "dc_energy", "op_carbon",
              "cooling_energy", "pv_energy", "energy_cost"):
        ref_v = float(base[k])
        err = abs(float(got[k]) - ref_v) / max(abs(ref_v), 1e-6)
        assert err <= rel, f"{store} {k}: rel err {err:.2e} > {rel}"
    assert any(float(got[k]) != float(base[k]) for k in base)


def test_ops_plain_path_is_taken_only_for_cpu_tensors():
    """The CPU path counts no launch; no switch reroutes the card."""
    ops.reset_launch_counts()
    ops.first_fit_place(*(T(x) for x in _ff_inputs(4, 3, 0)))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("s", [1, 255, 1024, 2880, 35040])
def test_facility_series_plan_fits_two_blocks_an_sm(s):
    """Kernel 3's series route keeps the totals route's tiles and adds one
    SoC tile a round to shared memory; two of its largest blocks still fit
    on an H100 SM."""
    tile, n_tiles, smem = fs.launch_plan(s, series=True)
    assert (tile, n_tiles) == fs.launch_plan(s)[:2]
    assert smem == fs.smem_bytes(tile) + 4 * 2 * tile
    assert 2 * fs.smem_bytes(fs.TILE_MAX, series=True) <= 228 * 1024


@pytest.mark.parametrize("b,s", [(1, 1), (1, 2880), (3, 255)])
def test_facility_series_launch_passes_its_outputs(recorded_launch, b, s):
    """The series route's entry point takes the totals route's arguments
    plus the [B, F, S] series and [B, S] decision buffers, and counts its
    launch under its own name."""
    rng = np.random.default_rng(s)
    x = [T(rng.uniform(lo, hi, (b, s)).astype(np.float32)) for lo, hi in (
        (20, 80), (50, 600), (5, 25), (0.05, 0.2), (0.04, 0.1), (0.1, 0.3),
        (0, 1), (50, 600))] + [T(rng.uniform(size=(b, s)) < 0.5)]
    cfg = _cfg(pconfig, True, True, True, "blended")
    ops.reset_launch_counts()
    acc, series, want = fs.launch_series(*fs.prepare(*x, cfg))
    (args,) = recorded_launch.calls
    assert len(args) == 18
    fcfg, store, nb = args[11]._obj, args[12], args[13]
    assert (fcfg.n_steps, fcfg.tile, store, nb) == (
        s, fs.launch_plan(s, series=True)[0], 0, b)
    assert [a.value for a in args[14:17]] == [
        t.data_ptr() for t in (acc, series, want)]
    assert acc.shape == (b, fs.N_ACC)
    assert series.shape == (b, fs.N_SERIES, s) and want.shape == (b, s)
    assert want.dtype == torch.uint8
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "fused_facility_series": 1}


def test_series_rows_map_to_the_chain_keys():
    """Each row of the series block is its `ref.fused_facility_chain` key
    (a view, no copy); the decision bytes read as bools; the derate echo
    is the series given, ones when healthy."""
    series = torch.arange(2 * fs.N_SERIES * 5, dtype=torch.float32).reshape(
        2, fs.N_SERIES, 5)
    want = torch.tensor([[0, 1, 0, 1, 1], [1, 0, 0, 0, 1]], dtype=torch.uint8)
    flows = fs.flows_from_series(series, want)
    for i, key in enumerate(fs.SERIES_FIELDS):
        assert torch.equal(flows[key], series[:, i])
        assert flows[key].data_ptr() == series[:, i].data_ptr()
    assert torch.equal(flows["want_charge"], want.bool())
    assert torch.equal(flows["chiller_derate"], torch.ones(2, 5))
    derate = torch.tensor([1.0, 0.5, 1.0, 0.5, 1.0])
    flows = fs.flows_from_series(series, want, derate)
    assert torch.equal(flows["chiller_derate"], derate.expand(2, 5))
    cfg = _cfg(pconfig, True, True, True, "carbon")
    keys = ref.fused_facility_chain(*[torch.ones(8)] * 8,
                                    torch.ones(8, dtype=torch.bool), DT, cfg)
    assert set(flows) == set(keys)
