"""One run of one cell: set-up, warm-up, the window, the traced chunks, the
check against the reference, and the result."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch

from benchmark.harness import loader, peaks
from benchmark.harness.check import Check
from benchmark.harness.rollout import SPANS, Rollout, p99
from benchmark.harness.trace import Trace, busy_seconds
from benchmark.reference import config as RC
from benchmark.reference import state_io

# The traced run profiles two stretches of two whole chunks each (every
# chunk ends in its reset). Chunks 3-4 with host ops and spans recorded,
# for what each layer launches and its device time; chunks 5-6 with device
# activity alone, for the busy share at the host's own pace (the op
# recording slows the host about twofold). Chunk 6 ends in the reset where
# the first episodes reach the 1,000-step limit (129 + 7 * 128 steps after
# the spawn tick and the warm-up chunk).
SPAN_CHUNKS = (3, 4)
BUSY_CHUNKS = (5, 6)
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_car_racing_tpu")


@dataclasses.dataclass
class View:
    """What a work counter reads: the reference's configuration and states."""

    cfg: object
    pre: object
    post: object


class MetricContext:
    """What a per-layer metric reads: the trace, the span calls and the work
    of the traced stretch."""

    def __init__(self, trace: Trace, work: dict, counts: dict, observation: str,
                 busy_s: float, busy_window_s: float):
        self.trace, self._work, self._counts = trace, work, counts
        self.observation = observation
        self.busy_s, self.busy_window_s = busy_s, busy_window_s   # device activity alone

    def per_call_ms(self, span: str) -> float | None:
        calls = self.trace.calls.get(span, 0)
        if not calls or not self.trace.count(span):
            return None
        return 1e3 * self.trace.device_s(span) / calls

    def launches_per_call(self, span: str) -> float | None:
        calls = self.trace.calls.get(span, 0)
        return self.trace.count(span) / calls if calls and self.trace.count(span) else None

    def roofline_pct(self, count: str) -> float | None:
        """100 x the least time of the counted work over the kernels' time
        in the span that launches them (``env.step`` or ``obs``)."""
        mod = self._counts[count]
        span = "env.step" if mod.WHEN == "step" else "obs"
        kernel_s = self.trace.device_s(span, set(mod.KERNELS))
        work = self._work.get(count, [])
        if kernel_s <= 0 or not work:
            return None
        return 100.0 * sum(peaks.least_seconds(f, b) for f, b in work) / kernel_s


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _ref_state(state):
    return state_io.env_state(state_io.tree(state))


def replay_work(cell: loader.Cell, seed: int, device: torch.device, count_mods: dict):
    """The traced chunks once more, each step's and each observation's work
    counted on the states they pass through: a fresh rollout of the same
    seed, set up and warmed up as the run was, driven to the first traced
    chunk (so no copy of the state is held through the window). Returns
    (work by counter, the cars' positions after the chunks)."""
    ro = Rollout(cell, seed, device)
    ro.warm_up()
    for _ in range(SPAN_CHUNKS[0] * ro.T):
        ro.decision(capture=False, capture_resets=False)
    cfg = RC.EnvConfig(**cell.config["env"])
    penv, state = ro.penv, ro.state
    ro.state = None                  # the chunks' states are held here only, one at a time
    work = {name: [] for name in count_mods}
    for d in range(SPAN_CHUNKS[0] * ro.T, (SPAN_CHUNKS[1] + 1) * ro.T):
        action = ro.policy(state)
        for _ in range(ro.R):
            pre = state
            state, _, _ = penv.step(ro.cfg, state, action)
            view = View(cfg, _ref_state(pre), _ref_state(state))
            for name, mod in count_mods.items():
                if mod.WHEN == "step":
                    work[name].append(mod.work(view))
        view = View(cfg, None, _ref_state(state))
        for name, mod in count_mods.items():
            if mod.WHEN == "obs":
                work[name].append(mod.work(view))
        if (d + 1) % ro.T == 0:
            state = penv.reset_done_envs(ro.cfg, state, ro.pool, ro.gen)
    return work, state.cars.hull_c


def run(cell: loader.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False, min_decisions: int = 0) -> dict:
    """One run; returns the result line's object (with ``check`` last) and
    the lines for standard error under ``"_lines"``. ``control`` compares
    the reference in bfloat16 in the program's place (``tools/control.py``);
    ``min_decisions`` makes the window hold at least that many decisions
    (for the tests on the CPU)."""
    lines = []
    cuda = device.type == "cuda"
    ro = Rollout(cell, seed, device)
    ro.warm_up()
    prof_box, replay = {}, {}
    on_chunk = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        min_decisions = max(min_decisions, (BUSY_CHUNKS[1] + 1) * ro.T + 1)  # the next chunk starts
        device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]

        def sync():
            if cuda:
                torch.cuda.synchronize(device)

        def on_chunk(c):
            if c == SPAN_CHUNKS[0]:
                sync()
                prof_box["spans"] = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof_box["spans"].__enter__()
                ro.span = record_function
                prof_box["t0"] = time.perf_counter()
            elif c == SPAN_CHUNKS[1] + 1:
                sync()
                prof_box["t1"] = time.perf_counter()
                prof_box["spans"].__exit__(None, None, None)
                ro.span = lambda name: contextlib.nullcontext()
                replay["end"] = ro.state.cars.hull_c.clone()
            if c == BUSY_CHUNKS[0]:
                sync()
                prof_box["busy"] = profile(activities=device_only)
                prof_box["busy"].__enter__()
                prof_box["b0"] = time.perf_counter()
            elif c == BUSY_CHUNKS[1] + 1:
                sync()
                prof_box["b1"] = time.perf_counter()
                prof_box["busy"].__exit__(None, None, None)
    t_first = time.perf_counter()
    window_s = ro.run_window(seconds, min_decisions, on_chunk)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = ro.decisions, int(ro.bad)
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}}
    metrics = {}
    if not trace:
        ms = ro.decision_ms() if cuda else []
        values = {
            "env_steps_per_s": ro.E * ro.R * attempted / window_s,
            "decision_ms_p99": p99(ms) if ms else None,
            "setup_s": t_first - t_start,
        }
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        lines.append(f"window: {attempted} decisions of {ro.E} envs x {ro.R} steps in "
                     f"{window_s:.3f} s")
        if ms:
            srt = sorted(ms)
            slow = sorted(range(len(ms)), key=ms.__getitem__)[-max(1, len(ms) // 100):]
            lines.append(f"decision ms: median {srt[len(srt) // 2]:.3f}, p99 {p99(ms):.3f}, "
                         f"max {srt[-1]:.3f}; the slowest 1% at decisions {sorted(slow)}")
    else:
        n_dec = len(SPAN_CHUNKS) * ro.T
        calls = {"policy": n_dec, "env.step": n_dec * ro.R, "obs": n_dec, "finite": n_dec,
                 "reset": len(SPAN_CHUNKS)}
        tr = Trace(prof_box.pop("spans"), prof_box["t1"] - prof_box["t0"], SPANS, calls)
        busy_s = busy_seconds(prof_box.pop("busy"))
        busy_window_s = prof_box["b1"] - prof_box["b0"]
        metric_mods = {m["name"]: loader.module("metrics", m["name"]) for m in cell.per_layer}
        count_mods = {c: loader.module("counts", c)
                      for mod in metric_mods.values() for c in getattr(mod, "COUNTS", ())}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}

    # The program's state is freed before the replay and the check.
    captures, sample, observation = ro.captures, ro.sample, ro.observation
    env_cfg, seeds, E, P = cell.config["env"], ro.track_seeds, ro.E, ro.P
    start_gen = captures[0].gen_state
    del ro
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        work, end = replay_work(cell, seed, device, count_mods)
        lines.append(f"replay of the traced chunks equals the traced run: "
                     f"{torch.equal(end, replay['end'])}")
        del end
        if cuda:
            torch.cuda.empty_cache()
        ctx = MetricContext(tr, work, count_mods, observation, busy_s, busy_window_s)
        for m in cell.per_layer:
            v = metric_mods[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        dev.update(busy_s=busy_s, window_s=busy_window_s)
    result["metrics"] = metrics
    result["device"] = dev
    t_check = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    chk = Check(env_cfg, seeds, E, P, sample, observation, device, control=control)
    with torch.no_grad():
        for cap in captures:
            if cap.kind == "decision":
                chk.decision(cap)
            else:
                chk.fresh(cap.states[-1], cap.states[0] if cap.kind == "reset" else None,
                          start_gen if cap.kind == "start" else cap.gen_state,
                          f"{cap.kind} {cap.index}")
    torch.set_num_threads(threads)
    numbers = chk.numbers()
    limits = cell.workload["limits"]
    floors = cell.workload.get("floors", {})       # counts of compared work the sample must reach
    ok = (chk.units["steps"] > 0 and all(numbers[k] <= limits[k] for k in numbers)
          and all(chk.units[k] >= v for k, v in floors.items()))
    result["correct"] = bool(ok)
    lines.append(f"check ({time.perf_counter() - t_check:.1f} s): "
                 + ", ".join(f"{k} {v}" for k, v in chk.units.items()))
    for k, v in numbers.items():
        if chk.worst[k]:
            lines.append(f"worst {k}: {chk.worst[k][:400]}")
    for k, v in floors.items():
        lines.append(f"{k} {chk.units[k]!r} floor {v!r}")
    for k, v in numbers.items():
        lines.append(f"{k} {v!r} limit {limits[k]!r}")
    result["check"] = {**{k: {"value": chk.units[k], "floor": v} for k, v in floors.items()},
                       **{k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}}
    result["_lines"] = lines
    return result
