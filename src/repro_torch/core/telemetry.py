"""Observability layer: spans, run records, the compile monitor, probe bus.

Everything here costs nothing when disabled (the default):

* :func:`span` / :func:`stage_scope` return ``nullcontext`` unless a
  :class:`Telemetry` session is active, and the engine composes its stage
  scopes once, before the step loop, only while one is: with no session
  the loop runs the same ops and launches.  Spans measure host time and
  annotate device traces; they never touch values, so results are bit for
  bit the same with a session on or off.
* The per-step probe bus is opt-in via ``SimConfig.probes``: a ring of the
  last K strided samples (:class:`ProbeRing`, ``SimState.probes``), None
  when ``ProbeConfig.enabled`` is False.

Host spans export as Chrome-trace JSON (Perfetto, ``chrome://tracing``);
device-side stage boundaries come from :func:`stage_scope`, a
``torch.profiler.record_function`` while a profiler records (plus an NVTX
range where the run's tensors are on a card) around every engine stage and
the megakernel's two halves.

Compiles.  The port's only compiles are its kernel builds:
``kernels/build.py`` reports each ``nvcc`` build and each load of a built
library to the compile monitor (:func:`note_compile`), with its seconds, as
the reference counts JAX backend compiles, persistent-cache loads
included.  The monitor powers the compile / execute split of
:class:`RunRecord` and the :func:`recompile_guard` detector.

Run records mirror the reference's fields, with two renamed for this
port: the reference's ``jax_backend`` is ``platform`` (``"cuda"`` or
``"cpu"``, the run's device) and ``pallas_interpret`` is ``plain_kernels``
(True where the kernels' plain versions ran, from ``kernels/ops.py``).
Only the outermost recorder of nested runs cuts a record.

Activate for a whole process with ``STEAM_TELEMETRY=1`` (output under
``STEAM_TELEMETRY_DIR``, default ``results/telemetry``), or locally::

    from repro_torch.core import telemetry
    with telemetry.session() as tel:
        sweep_grid(...)
    # tel.export_chrome_trace() written on exit; run records in
    # results/telemetry/run_records.jsonl
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
import time
import uuid
import warnings
from typing import Any, NamedTuple, Optional

import torch


class RecompileError(RuntimeError):
    """Raised by :func:`recompile_guard` under ``policy="raise"``."""


# ---------------------------------------------------------------------------
# Compile monitor (module-level; kernels/build.py reports to it)
# ---------------------------------------------------------------------------

class _CompileMonitor:
    """Accumulates kernel-build count and seconds."""

    def __init__(self) -> None:
        self.count = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.seconds += float(seconds)


_MONITOR = _CompileMonitor()


def note_compile(seconds: float) -> None:
    """One kernel build (an `nvcc` run) or load of a built library, taking
    `seconds`: kernels/build.py's hook."""
    _MONITOR.add(seconds)


class CompileWatch:
    """Delta view over the compile monitor; see :func:`compile_watch`."""

    def __init__(self) -> None:
        self._count0 = _MONITOR.count
        self._seconds0 = _MONITOR.seconds

    @property
    def count(self) -> int:
        return _MONITOR.count - self._count0

    @property
    def seconds(self) -> float:
        return _MONITOR.seconds - self._seconds0


@contextlib.contextmanager
def compile_watch():
    """Count kernel builds and loads (and their seconds) inside the block.

    Works standalone, with no telemetry session, so a benchmark can split
    build time from steady-state throughput without capturing spans.
    """
    yield CompileWatch()


class RecompileGuard:
    """Detects per-unit-of-work recompilation inside a block.

    Call :meth:`tick` after each unit (grid cell, chunk, bench rep).  A
    unit during which at least one build or load fired counts as one
    *burst*; on exit, ``bursts > allowed`` triggers the policy
    (``"warn"`` → UserWarning, ``"raise"`` → :class:`RecompileError`,
    ``"ignore"`` → nothing).  Counting bursts rather than events is robust
    to one unit building several libraries.
    """

    def __init__(self, label: str, allowed: int = 1,
                 policy: str = "warn") -> None:
        if policy not in ("warn", "raise", "ignore"):
            raise ValueError(f"unknown recompile policy {policy!r}")
        self.label = label
        self.allowed = allowed
        self.policy = policy
        self.bursts = 0
        self.compiles = 0
        self._count0 = 0
        self._burst_mark = 0

    def __enter__(self) -> "RecompileGuard":
        self._count0 = _MONITOR.count
        self._burst_mark = _MONITOR.count
        self._ticked = False
        return self

    def mark(self) -> None:
        """Start a unit-of-work window: compiles before the next `tick`
        count toward a burst.  Use mark/tick pairs to leave out unrelated
        builds between units."""
        self._burst_mark = _MONITOR.count

    def tick(self) -> None:
        """Mark the end of one unit of work (cell / chunk / call)."""
        if _MONITOR.count > self._burst_mark:
            self.bursts += 1
        self._burst_mark = _MONITOR.count
        self._ticked = True

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._ticked:
            self.tick()  # plain-block usage: the whole block is one unit
        self.compiles = _MONITOR.count - self._count0
        if exc_type is not None:
            return
        if self.bursts > self.allowed:
            msg = (f"telemetry: {self.label!r} recompiled in {self.bursts} "
                   f"units of work (allowed {self.allowed}, "
                   f"{self.compiles} kernel builds total) — a sweep that "
                   f"rebuilds per cell usually means a kernel source or "
                   f"its build flags change between cells")
            if self.policy == "raise":
                raise RecompileError(msg)
            if self.policy == "warn":
                warnings.warn(msg, UserWarning, stacklevel=2)


def recompile_guard(label: str, allowed: int = 1,
                    policy: Optional[str] = None) -> RecompileGuard:
    """Context manager: fail/warn when a block recompiles per unit of work.

    ``policy=None`` inherits the active session's ``recompile_policy``
    (default ``"warn"`` when no session is active).
    """
    if policy is None:
        tel = _ACTIVE
        policy = tel.recompile_policy if tel is not None else "warn"
    return RecompileGuard(label, allowed=allowed, policy=policy)


# ---------------------------------------------------------------------------
# Run records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunRecord:
    """One structured record per simulate/fleet/grid run (JSONL row)."""

    kind: str                       # "simulate" | "fleet" | "grid"
    run_id: str
    timestamp: str                  # ISO-8601 UTC
    config_hash: str
    backend: str                    # cfg.backend
    use_pallas: bool
    trace_store: str
    n_steps: int
    dt_h: float
    platform: str                   # "cuda" | "cpu": the run's device
    device_count: int
    devices: list
    compile_time_s: float
    execute_time_s: float
    compiles: int
    plain_kernels: Optional[bool] = None
    grid_shape: Optional[list] = None
    chunk: Optional[dict] = None    # chunk plan: predicted vs actual bytes
    mesh: Optional[dict] = None
    memory: Optional[list] = None   # per-device allocator watermarks
    trace_dtypes: Optional[dict] = None
    probes: Optional[dict] = None   # {"stride": ..., "capacity": ...}
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)

    @classmethod
    def from_json(cls, line: str) -> "RunRecord":
        return cls(**json.loads(line))


def config_hash(cfg: Any) -> str:
    """Stable short hash of a frozen-dataclass config (repr-based)."""
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Telemetry session
# ---------------------------------------------------------------------------

class Telemetry:
    """An active observability session: spans + run records + settings."""

    def __init__(self, out_dir: Optional[str] = None,
                 recompile_policy: str = "warn") -> None:
        self.out_dir = out_dir or os.environ.get(
            "STEAM_TELEMETRY_DIR", os.path.join("results", "telemetry"))
        self.recompile_policy = recompile_policy
        self.events: list = []          # Chrome-trace events
        self.records: list = []         # RunRecords emitted this session
        self.last_plain_kernels: Optional[bool] = None
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._depth = 0                 # nested run recorders

    # -- spans ------------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        """Host-side timed span, recorded as a Chrome-trace "X" event."""
        ts = self._now_us()
        try:
            yield
        finally:
            dur = self._now_us() - ts
            ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                  "pid": os.getpid(), "tid": threading.get_ident() % 100_000}
            if args:
                ev["args"] = {k: _json_safe(v) for k, v in args.items()}
            with self._lock:
                self.events.append(ev)

    def span_durations(self, name: str) -> list:
        """Total µs durations of all spans with the given name."""
        return [e["dur"] for e in self.events if e["name"] == name]

    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        """Write the host-span Chrome trace JSON; returns the path."""
        path = path or os.path.join(self.out_dir, "trace.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    # -- run records ------------------------------------------------------
    def record(self, rec: RunRecord) -> RunRecord:
        with self._lock:
            self.records.append(rec)
        path = os.path.join(self.out_dir, "run_records.jsonl")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(rec.to_json() + "\n")
        return rec


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


_ACTIVE: Optional[Telemetry] = None


def get() -> Optional[Telemetry]:
    """The active session, or None when telemetry is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def enable(out_dir: Optional[str] = None,
           recompile_policy: str = "warn") -> Telemetry:
    """Activate a telemetry session (module-level singleton)."""
    global _ACTIVE
    _ACTIVE = Telemetry(out_dir=out_dir, recompile_policy=recompile_policy)
    return _ACTIVE


def disable() -> Optional[Telemetry]:
    """Deactivate; returns the session that was active (for inspection)."""
    global _ACTIVE
    tel, _ACTIVE = _ACTIVE, None
    return tel


@contextlib.contextmanager
def session(out_dir: Optional[str] = None, recompile_policy: str = "warn",
            export: bool = True):
    """``with telemetry.session() as tel: ...`` — enable, export, disable."""
    tel = enable(out_dir=out_dir, recompile_policy=recompile_policy)
    try:
        yield tel
    finally:
        if export and tel.events:
            tel.export_chrome_trace()
        disable()


def span(name: str, **args: Any):
    """Host span on the active session; nullcontext when disabled."""
    tel = _ACTIVE
    if tel is None:
        return contextlib.nullcontext()
    return tel.span(name, **args)


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def stage_scope(name: str, device=None):
    """Annotation of an engine stage / megakernel half in device profiles.

    A ``torch.profiler.record_function`` range while a profiler records
    (it records nothing otherwise, and costs host time a call), plus an
    NVTX range where `device` (the run's) is a card.  Returns
    ``nullcontext`` when no session is active.
    """
    if _ACTIVE is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if torch._C._autograd._profiler_enabled():
        stack.enter_context(torch.profiler.record_function(name))
    if _on_card(device):
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


def note_plain_kernels(plain: bool) -> None:
    """Record how the last kernel call resolved (kernels/ops.py hook):
    True where the plain version ran."""
    tel = _ACTIVE
    if tel is not None:
        tel.last_plain_kernels = bool(plain)


def profile(fn, *args, logdir: Optional[str] = None, **kwargs):
    """One-command capture: run ``fn(*args, **kwargs)`` under
    ``torch.profiler.profile`` (CPU activity, and CUDA activity where a
    card is present), synchronize, and write a Chrome trace into `logdir`
    (``trace.json``).  Returns ``(result, logdir)``.
    """
    from torch.profiler import ProfilerActivity
    tel = _ACTIVE
    base = tel.out_dir if tel is not None else os.environ.get(
        "STEAM_TELEMETRY_DIR", os.path.join("results", "telemetry"))
    logdir = logdir or os.path.join(base, "profile")
    os.makedirs(logdir, exist_ok=True)
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if card else [])
    with torch.profiler.profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out, logdir


# ---------------------------------------------------------------------------
# Run-record emission helper
# ---------------------------------------------------------------------------

def _utc_now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class _RecordDraft:
    """Mutable scratch a run wrapper fills in before the record is cut."""

    def __init__(self) -> None:
        self.grid_shape: Optional[list] = None
        self.chunk: Optional[dict] = None
        self.mesh: Optional[dict] = None
        self.trace_dtypes: Optional[dict] = None
        self.extra: dict = {}
        self.record: Optional[RunRecord] = None


def _synchronize(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def run_recorder(kind: str, cfg: Any, device=None, **extra: Any):
    """Wrap one run on `device`: times it, splits build time from execute
    time, cuts a record.  Only the outermost recorder of nested runs cuts
    one (a grid's record, not its chunks').  Before the block ends it
    synchronizes the run's device, so the execute time covers the device's
    work; with no active session it does nothing.
    """
    tel = _ACTIVE
    draft = _RecordDraft()
    if tel is None or tel._depth:
        if tel is not None:
            tel._depth += 1
        try:
            yield draft
        finally:
            if tel is not None:
                tel._depth -= 1
        return
    draft.extra.update(extra)
    tel._depth += 1
    try:
        with compile_watch() as watch:
            t0 = time.perf_counter()
            with tel.span(kind, backend=getattr(cfg, "backend", None)):
                yield draft
                _synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        tel._depth -= 1
    compile_s = min(watch.seconds, wall)
    pcfg = getattr(cfg, "probes", None)
    probes = None
    if pcfg is not None and pcfg.enabled:
        probes = {"stride": max(int(pcfg.stride), 1),
                  "capacity": probe_capacity(cfg.n_steps, pcfg)}
    card = _on_card(device)
    draft.record = tel.record(RunRecord(
        kind=kind,
        run_id=uuid.uuid4().hex[:12],
        timestamp=_utc_now_iso(),
        config_hash=config_hash(cfg),
        backend=getattr(cfg, "backend", "?"),
        use_pallas=bool(getattr(cfg, "use_pallas", False)),
        trace_store=getattr(cfg, "trace_store", "?"),
        n_steps=int(getattr(cfg, "n_steps", 0)),
        dt_h=float(getattr(cfg, "dt_h", 0.0)),
        platform="cuda" if card else "cpu",
        device_count=torch.cuda.device_count() if card else 1,
        devices=([torch.cuda.get_device_name(i)
                  for i in range(torch.cuda.device_count())]
                 if card else ["cpu"]),
        compile_time_s=compile_s,
        execute_time_s=max(wall - compile_s, 0.0),
        compiles=watch.count,
        plain_kernels=tel.last_plain_kernels,
        memory=device_memory_watermarks(),
        grid_shape=draft.grid_shape,
        chunk=draft.chunk,
        mesh=draft.mesh,
        trace_dtypes=draft.trace_dtypes,
        probes=probes,
        extra=draft.extra,
    ))


def device_memory_watermarks() -> list:
    """Per-card allocator stats (`torch.cuda.max_memory_allocated` and
    `memory_allocated`) of every visible card; where there is none, one CPU
    entry whose values are None, as the reference's CPU backend reports:
    absence is data, printed beside the predicted chunk-plan bytes so a
    reader can tell "no watermark available" from "zero bytes"."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "peak_bytes_in_use": None,
                 "bytes_in_use": None}]
    return [{"device": f"cuda:{i}",
             "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
             "bytes_in_use": int(torch.cuda.memory_allocated(i))}
            for i in range(torch.cuda.device_count())]


def peak_bytes_per_device() -> Optional[int]:
    """Max ``peak_bytes_in_use`` across cards, or None (CPU)."""
    peaks = [m["peak_bytes_in_use"] for m in device_memory_watermarks()
             if m["peak_bytes_in_use"] is not None]
    return max(peaks) if peaks else None


# ---------------------------------------------------------------------------
# Per-step probe bus
# ---------------------------------------------------------------------------

class Probes(NamedTuple):
    """Strided ring-buffer samples of a run.

    Fields are ``[..., K]`` tensors (``K`` = :func:`probe_capacity`; a
    leading scenario axis for runs of several rows); entries whose ``step``
    is ``-1`` were never written (horizon shorter than the buffer).  Fields
    mirror the settled :class:`~.engine.EnergyFlow` ledger for the step,
    plus battery state of charge (post-dispatch), the intra-billing-window
    running peak (post-pricing), the scheduler queue depth (tasks arrived
    but still pending), and the resilience series: the thermal throttle the
    step ran under, the chiller derate and the PDU power cap in force (1.0 /
    1.0 / +inf whenever ``cfg.resilience`` is off — the channels exist on
    both executors regardless, so probe consumers never branch on the
    config).  The value fields of a run's probes are views of one
    ``[..., F, K]`` buffer (:class:`ProbeRing`).
    """

    step: torch.Tensor             # i32[..., K]: sim step of the sample
    it_kw: torch.Tensor
    cooling_kw: torch.Tensor
    pv_kw: torch.Tensor
    batt_charge_kw: torch.Tensor
    batt_discharge_kw: torch.Tensor
    grid_import_kw: torch.Tensor
    grid_export_kw: torch.Tensor
    curtailed_kw: torch.Tensor
    soc_kwh: torch.Tensor          # battery charge after dispatch
    window_peak_kw: torch.Tensor   # running intra-window demand peak
    queue_depth: torch.Tensor      # arrived-but-pending tasks
    throttle_factor: torch.Tensor  # thermal throttle APPLIED this step
    chiller_derate: torch.Tensor   # facility-failure derate (1 = healthy)
    pdu_cap_kw: torch.Tensor       # rack-power clamp in force (+inf = ok)


PROBE_VALUE_FIELDS = tuple(f for f in Probes._fields if f != "step")


class ProbeRing(NamedTuple):
    """The probe bus as a run carries it (``SimState.probes``): the sampled
    steps, i32 ``[..., K]``, and every value field's samples in one f32
    ``[..., F, K]`` buffer (F = ``len(PROBE_VALUE_FIELDS)``, in that
    order), so a sampled step is one write."""

    step: torch.Tensor
    values: torch.Tensor

    def probes(self) -> Probes:
        """The ring as :class:`Probes` (the value fields are views)."""
        return Probes(self.step, *self.values.unbind(-2))


def probe_capacity(n_steps: int, pcfg: Any) -> int:
    """Ring-buffer length: all strided samples, capped at max_samples."""
    stride = max(int(pcfg.stride), 1)
    total = -(-int(n_steps) // stride)
    if pcfg.max_samples and pcfg.max_samples > 0:
        return min(int(pcfg.max_samples), total)
    return total


def init_probes(n_steps: int, pcfg: Any, rows: tuple = (),
                device="cuda") -> ProbeRing:
    """The ring of a run of `rows` scenario rows on `device`, unwritten."""
    k = probe_capacity(n_steps, pcfg)
    return ProbeRing(
        step=torch.full((*rows, k), -1, dtype=torch.int32, device=device),
        values=torch.zeros((*rows, len(PROBE_VALUE_FIELDS), k),
                           dtype=torch.float32, device=device))


def probe_write(ring: ProbeRing, step: int, stride: int,
                values: dict) -> ProbeRing:
    """Write step `step`'s sample (a host int: the loop's index) if the
    stride takes it; the engine's probe stage.  `values` holds a tensor a
    field, each broadcastable to the ring's rows plus one ([B, 1]).  Rows
    wrap modulo the capacity, so a capped ring keeps the **last** ``K``
    strided samples.  A step the stride skips launches nothing; one it
    takes makes one [..., F] write of the stacked values and one of the
    step."""
    if step % stride:
        return ring
    k = ring.step.shape[-1]
    row = (step // stride) % k
    lead = (*ring.values.shape[:-2], 1)
    ring.values[..., row] = torch.cat(
        [values[f].to(torch.float32).expand(lead)
         for f in PROBE_VALUE_FIELDS], -1)
    ring.step[..., row] = step
    return ring


def sample_steps(n_steps: int, pcfg: Any) -> list:
    """The step of each ring entry once the run has ended: entry ``j``
    holds the last sample whose index is ``j`` modulo the capacity."""
    stride = max(int(pcfg.stride), 1)
    k = probe_capacity(n_steps, pcfg)
    total = -(-int(n_steps) // stride)
    # last sample index landing on ring row j: j + floor((total-1-j)/K)*K
    return [(j + ((total - 1 - j) // k) * k) * stride for j in range(k)]


def probes_from_series(n_steps: int, pcfg: Any, series: dict) -> ProbeRing:
    """Assemble the same ring from full per-step series ([..., S] each).

    The megakernel computes facility physics over the whole horizon rather
    than step by step; this gathers the same strided samples (ring
    wrap-around included: row ``j`` holds the *last* sample whose index is
    ``j`` mod K), so both executors export the same probes: one stack and
    one gather.
    """
    first = series[PROBE_VALUE_FIELDS[0]]
    # made on the host, copied without waiting for the device
    steps = torch.tensor(sample_steps(n_steps, pcfg), dtype=torch.int64).to(
        first.device, non_blocking=True)
    shape = torch.broadcast_shapes(*(series[f].shape
                                     for f in PROBE_VALUE_FIELDS))
    stacked = torch.stack([torch.broadcast_to(series[f].to(torch.float32),
                                              shape)
                           for f in PROBE_VALUE_FIELDS], -2)
    return ProbeRing(step=steps.to(torch.int32).expand(
                         *shape[:-1], steps.shape[0]).contiguous(),
                     values=stacked[..., steps])


def window_peak_series(grid_kw: torch.Tensor,
                       window_steps: int) -> torch.Tensor:
    """Running intra-billing-window peak at every step ([..., S]).

    Matches ``pricing.pricing_step`` exactly: the window resets at steps
    ``k*W`` (k>0) *before* absorbing that step's demand, so the peak at
    step t covers ``grid_kw[..., (t//W)*W : t+1]`` — a per-window cummax
    after padding to a multiple of W (a maximum is exact in any order).
    """
    s = grid_kw.shape[-1]
    w = max(int(window_steps), 1)
    n_win = -(-s // w)
    pad = n_win * w - s
    lead = grid_kw.shape[:-1]
    padded = (torch.cat([grid_kw, grid_kw.new_zeros(*lead, pad)], -1)
              if pad else grid_kw)
    peaks = torch.cummax(padded.reshape(*lead, n_win, w), -1).values
    return peaks.reshape(*lead, n_win * w)[..., :s]


# Activate from the environment (used by CI bench-smoke).
if os.environ.get("STEAM_TELEMETRY", "") not in ("", "0"):
    enable()
