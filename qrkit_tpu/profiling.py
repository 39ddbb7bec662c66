"""Tracing / profiling harness (SURVEY §5.1 — strictly more than parity).

The reference's only instrumentation is ``clock()`` around ``lm.minimize``
(bench/bench_sparse_qr_extra.cpp:310-352).  Here:

* :func:`timed` — wall-clock a device computation correctly (blocks on the
  result, returns (value, seconds)).
* :class:`Timer` — accumulating named-section timer for driver loops.
* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard/Perfetto device trace; it raises if tracing cannot start.
* :func:`device_events` / :func:`stage_device_times` — the reduction from a
  trace to per-stage device time: each device kernel is mapped through its
  HLO instruction's ``op_name`` metadata to the ``jax.named_scope`` stage it
  ran under.
* :func:`count_dispatches` — context manager counting compiled-program
  executions.  Each costs a launch sequence plus host dispatch overhead; the
  fused paths advertise O(1)-dispatch behavior and tests pin it with this
  counter so a regression fails loudly.
"""
from __future__ import annotations

import contextlib
import glob
import os
import re
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Tuple

import jax

__all__ = [
    "timed",
    "Timer",
    "trace",
    "device_events",
    "hlo_op_names",
    "stage_device_times",
    "count_dispatches",
    "DispatchCount",
]


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0


class Timer:
    """Accumulating section timer: ``with timer("factorize"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t * 1e3:10.2f} ms total  {c:6d} calls  {t / c * 1e3:8.3f} ms/call")
        return "\n".join(lines)


class DispatchCount:
    """Mutable counter handed out by :func:`count_dispatches`."""

    def __init__(self):
        self.count = 0

    def __int__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return f"DispatchCount({self.count})"


@contextlib.contextmanager
def count_dispatches():
    """Count compiled-program executions (XLA dispatches) in the block.

    Every execution of a compiled program — a jitted function call, an eager
    op, a ``jnp.asarray`` device put — counts as one.  Each pays launch and
    host dispatch overhead, so the advertised O(1)-dispatch fused paths are
    worth pinning::

        with count_dispatches() as d:
            qr.factorize_values(v)
        assert d.count <= 1

    Nesting is safe (counters stack); the hook is removed on exit.  Counts
    host-side dispatch, so it works identically on the CPU test mesh and on
    the card.
    """
    import jax._src.pjit as _pjit
    from jax._src.interpreters import pxla

    counter = DispatchCount()
    orig_call = pxla.ExecuteReplicated.__call__
    orig_fp = _pjit._get_fastpath_data

    def counting(self, *args, **kwargs):
        counter.count += 1
        return orig_call(self, *args, **kwargs)

    # Warm jitted functions normally execute through jax's C++ fastpath,
    # which calls the XLA executable without touching any Python frame.
    # Returning None from _get_fastpath_data (and dropping already-installed
    # fastpath entries) routes every call through the Python executable
    # wrapper so it can be counted.  Dispatch gets slower inside the block;
    # nothing recompiles, and the fastpath re-installs itself afterwards.
    pxla.ExecuteReplicated.__call__ = counting
    _pjit._get_fastpath_data = lambda *a, **k: None
    for cache in (
        getattr(_pjit, "_cpp_pjit_cache_fun_only", None),
        getattr(_pjit, "_cpp_pjit_cache_explicit_attributes", None),
    ):
        try:
            cache.clear()
        except Exception:
            pass
    try:
        yield counter
    finally:
        pxla.ExecuteReplicated.__call__ = orig_call
        _pjit._get_fastpath_data = orig_fp


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace via jax.profiler (viewable in TensorBoard / Perfetto).

    Raises if the profiler cannot start, so a traced phase can never pass
    without producing its trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _newest_xplane(log_dir: str) -> str:
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {log_dir}")
    return max(paths, key=os.path.getmtime)


def device_events(log_dir: str, plane_prefix: str = "/device:") -> List[Dict[str, Any]]:
    """Every event on a device plane of the newest trace under ``log_dir``:
    ``{"plane", "line", "name", "start_ns", "dur_ns", "stats"}``.  Tests on
    the CPU backend read its executor events with ``plane_prefix="/host:CPU"``."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_newest_xplane(log_dir))
    out = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append(dict(
                    plane=plane.name, line=line.name, name=ev.name,
                    start_ns=ev.start_ns, dur_ns=ev.duration_ns,
                    stats=dict(ev.stats),
                ))
    return out


_INSTR = re.compile(r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> Tuple[str, Dict[str, str]]:
    """``(module name, {instruction name: op_name metadata})`` of a compiled
    module's text (``jitted.lower(...).compile().as_text()``).  A fusion
    without metadata of its own takes its fused computation's root's."""
    module = ""
    names: Dict[str, str] = {}
    calls: Dict[str, str] = {}
    roots: Dict[str, str] = {}
    comp = None
    for line in hlo_text.splitlines():
        if line.startswith("HloModule "):
            module = line.split()[1].rstrip(",")
            continue
        mc = _COMP.match(line)
        if mc:
            comp = mc.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        op = _OP_NAME.search(line)
        if op:
            names[m.group(2)] = op.group(1)
            if m.group(1) and comp is not None:
                roots[comp] = op.group(1)
        else:
            c = _CALLS.search(line)
            if c:
                calls[m.group(2)] = c.group(1)
    for instr, callee in calls.items():
        if callee in roots:
            names[instr] = roots[callee]
    return module, names


def _busy_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    busy, end = 0, None
    for s0, s1 in sorted(intervals):
        if end is None or s0 > end:
            busy += s1 - s0
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    return busy


def stage_device_times(
    events: List[Dict[str, Any]], hlo_texts: Iterable[str], stages: Iterable[str]
) -> Dict[str, Any]:
    """Attribute device kernel time to ``jax.named_scope`` stages.

    A device event names its HLO instruction (``hlo_op``) and module
    (``hlo_module``); the instruction's ``op_name`` metadata holds the scope
    path it was traced under.  Time of events in none of ``stages`` goes to
    ``"other"``; events whose module is not among ``hlo_texts`` are skipped.
    Also returns the busy time (union of event intervals), the window
    (first start to last end) and the unmatched kernel names."""
    stages = list(stages)
    by_module = dict(hlo_op_names(t) for t in hlo_texts)
    ns = dict.fromkeys(stages + ["other"], 0)
    kernels: Dict[str, int] = defaultdict(int)
    unmatched: Dict[str, int] = defaultdict(int)
    spans = []
    for ev in events:
        mod = str(ev["stats"].get("hlo_module", ""))
        if mod not in by_module:
            continue
        op = str(ev["stats"].get("hlo_op", ev["name"]))
        op_name = by_module[mod].get(op)
        if op_name is None:
            unmatched[op] += ev["dur_ns"]
        parts = (op_name or "").split("/")
        stage = next((st for st in stages if st in parts), "other")
        ns[stage] += ev["dur_ns"]
        kernels[f"{stage}:{op}"] += ev["dur_ns"]
        spans.append((ev["start_ns"], ev["start_ns"] + ev["dur_ns"]))
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    return dict(
        stage_ns=ns,
        busy_ns=_busy_ns(spans),
        window_ns=window,
        kernels_ns=dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
        unmatched_ns=dict(unmatched),
    )
