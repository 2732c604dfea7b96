"""Continuous-batching serving loop (port of `repro.serving.scheduler`, one
device).

A slot-based scheduler multiplexes many requests over one decode-step
function. Requests enter a FIFO queue; free slots are filled by per-slot
prefill; every engine tick decodes ONE token for ALL active slots;
finished sequences (EOS or max_tokens) free their slot at once -- no
head-of-line blocking on long generations.

Composes with the paper's technique: a TAF `approx_decode` config skips
stable layers inside the shared decode step, and the engine reports the
skipped-layer fraction alongside throughput.

QoS hook: pass `qos=QosEngine(...)` and the decode loop runs under a
controller-chosen spec. Each tick the engine groups live lanes by their
request class's current knob (`QosEngine.plan_tick`), actuates the
strictest live rung by writing the TAF threshold into the decode cache (a
tensor write: no step is rebuilt and no host read is added), and on
canary ticks runs the precise model from the same pre-tick state and feeds
the compared logits to the quality monitor. A hard fallback zeroes both
the threshold and the in-flight prediction counters, so "precise" takes
effect on the very next token.

The decode step updates the cache in place at the decoded position. A
canary therefore runs the precise step FIRST, on the pre-tick cache, and
the served step after it: the served step rewrites every layer's K/V at
that position, so the cache ends as the served step leaves it, as in the
JAX engine.

Per tick the engine reads the device once (the new tokens, with the TAF
`remaining` vector when the model runs decode TAF), the TAF decode step
once more (its `remaining` at the step's start), and a canary tick once
more (both logits); every read is counted in `obs.metrics.HOST_READS`.

Sharded serving (`mesh=`, `devices=`, `shards=`) comes with multi-GPU
(ROADMAP Queue 1 item 5) and the `lint=` pass with the analysis lint
(item 7); asking for either raises.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from ..core.types import ApproxSpec, Technique
from ..launch import steps as steps_mod
from ..models.lm import CACHE_BATCH_AXES, Model, build
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace
from ..obs.metrics import percentile as _percentile

SHARDED_ITEM = "ROADMAP Queue 1 item 5 (multi-GPU)"
LINT_ITEM = "ROADMAP Queue 1 item 7 (analysis lint)"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    qos_class: str = "default"      # maps to a QosEngine target class
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class KnobMove:
    """One actuator write: the typed record behind `knob_log`.

    `value`/`previous` are the threshold actually written (`previous` is
    None for the first actuation). `reason` classifies the move from the
    controller state and the value delta: init | tighten | loosen |
    fallback. Emitted as an obs `knob_move` event when tracing."""
    tick: int
    value: float
    previous: Optional[float]
    reason: str


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    tokens_out: int = 0
    finished: int = 0
    taf_skipped: int = 0
    taf_total: int = 0
    canary_ticks: int = 0           # ticks re-executed through the oracle
    knob_moves: int = 0             # actuator writes (QoS rung changes)
    # per-request latency samples (seconds), appended as requests progress:
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    latency_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def taf_skip_fraction(self) -> float:
        return self.taf_skipped / max(self.taf_total, 1)

    @property
    def ttft_p50(self) -> Optional[float]:
        return _percentile(self.ttft_s, 50)

    @property
    def ttft_p99(self) -> Optional[float]:
        return _percentile(self.ttft_s, 99)

    @property
    def latency_p50(self) -> Optional[float]:
        return _percentile(self.latency_s, 50)

    @property
    def latency_p99(self) -> Optional[float]:
        return _percentile(self.latency_s, 99)

    def latency_summary(self):
        """Time-to-first-token and end-to-end request latency, p50/p99."""
        return {
            "ttft_p50_s": self.ttft_p50, "ttft_p99_s": self.ttft_p99,
            "latency_p50_s": self.latency_p50,
            "latency_p99_s": self.latency_p99,
            "requests": len(self.latency_s),
        }


class ServingEngine:
    """Slot-based continuous batching over a fixed decode batch size, on
    the model's device."""

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 256, prompt_len: int = 32, qos=None,
                 mesh=None, devices: Optional[int] = None,
                 shards: Optional[int] = None, lint: bool = False):
        if mesh is not None or devices is not None or shards not in (None,
                                                                     1):
            raise NotImplementedError(
                f"sharded serving (mesh=, devices=, shards=) is not ported "
                f"yet ({SHARDED_ITEM})")
        if lint:
            raise NotImplementedError(
                f"the engine's lint pass is not ported yet ({LINT_ITEM})")
        self.model = model
        self.params = params
        self.n_slots = slots
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.queue: Deque[Request] = collections.deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)       # next write position
        self.limit = np.zeros(slots, np.int64)     # stop position
        self.stats = EngineStats()
        self._prefill = steps_mod.make_prefill_step(model, max_len)
        self._serve = steps_mod.make_serve_step(model)
        self.cache = None
        self.tokens = torch.zeros((slots,), dtype=torch.int32,
                                  device=model.device)
        self.qos = qos
        self._knob = None                    # last actuated threshold
        self.knob_events: List[KnobMove] = []
        self._serve_exact = None
        if qos is not None:
            if model.cfg.approx_decode.technique != Technique.TAF:
                raise ValueError(
                    "QoS-controlled serving needs decode-time TAF: build "
                    "the model with cfg.approx_decode = a TAF spec (the "
                    "threshold is the online actuator)")
            # the actuator writes ONLY the threshold, so every rung must
            # describe THIS model's decode step
            from ..qos import validate_ladder_taf
            validate_ladder_taf(qos.policy, model.cfg.approx_decode.taf)
            # the canary oracle: the SAME params through a precise decode
            # step; the cache's 'taf' entry rides through it untouched
            exact_model = build(dataclasses.replace(
                model.cfg, approx_decode=ApproxSpec()), device=model.device)
            self._serve_exact = steps_mod.make_serve_step(exact_model)

    @property
    def knob_log(self) -> List[tuple]:
        """`(tick, value)` view of `knob_events`."""
        return [(m.tick, m.value) for m in self.knob_events]

    @property
    def host_reads_per_tick(self) -> int:
        """Device reads a tick makes outside canaries: the tokens (with
        the TAF `remaining` vector), and the TAF decode step's own read."""
        return 2 if self.model.taf_enabled else 1

    def _knob_reason(self, val, prev) -> str:
        """Classify an actuator write from controller state + the value
        delta. The plan's knob realizes decisions the controllers took at
        the END of the previous tick, so `in_fallback` is current here."""
        if prev is None:
            return "init"
        if self.qos is not None and any(
                c.in_fallback for c in self.qos.controllers.values()):
            return "fallback"
        # lower TAF threshold => fewer skips => more precise
        return "tighten" if val < prev else "loosen"

    def _lane_write(self, cache, row, tokens, row_logits, lane: int):
        """Splice a batch-1 prefill into the live cache at `lane`, in
        place. Each leaf's batch axis is named in
        `models.lm.CACHE_BATCH_AXES`; leaves without one (the detector
        state, the knob thresholds) keep their LIVE values: admission does
        not reset another lane's quality state or the actuated knob."""
        for group, leaves in row.items():
            for name, r in leaves.items():
                axis = CACHE_BATCH_AXES[(group, name)]
                if axis is not None:
                    cache[group][name].select(axis, lane).copy_(
                        r.select(axis, 0))
        tokens[lane:lane + 1].copy_(
            torch.argmax(row_logits, dim=-1).to(tokens.dtype))

    def warmup(self):
        """Run prefill, serve, the canary oracle and the admission path
        once on throwaway state, so the first timed tick measures decode,
        not first-call setup. Engine state is untouched."""
        with trace.span("engine.warmup", slots=self.n_slots):
            prompts = np.zeros((self.n_slots, self.prompt_len), np.int32)
            logits, cache = self._prefill(self.params, {"tokens": prompts})
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            if self._serve_exact is not None:
                self._serve_exact(self.params, cache, tokens, self.prompt_len)
            self._serve(self.params, cache, tokens, self.prompt_len)
            if self.n_slots > 1:
                row_logits, row = self._prefill(
                    self.params,
                    {"tokens": np.zeros((1, self.prompt_len), np.int32)})
                self._lane_write(cache, row, tokens, row_logits, 0)
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)

    def submit(self, req: Request):
        req.submitted_at = time.time()
        self.queue.append(req)

    def _admit(self):
        """Fill free slots from the queue. The FIRST admission prefills
        the whole batch (there is no live cache yet); afterwards each
        arriving request costs one batch-1 prefill plus a per-lane cache
        splice, which leaves ongoing lanes' KV, detector state and the
        actuated knob untouched."""
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free or not self.queue:
            return
        admitted = []
        for i in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            self.active[i] = req
            self.pos[i] = self.prompt_len
            self.limit[i] = min(self.prompt_len + req.max_new_tokens,
                                self.max_len)
            admitted.append(i)
        if not admitted:
            return
        # one-slot engines re-prefill the whole batch and so reset the
        # detector, as the JAX engine does (its shape-matching splice cannot
        # tell a 1-slot batch dim from batchless detector state); the port's
        # named batch axes could splice here, but it keeps the reference's
        # streams and skip counts (tests/test_torch_serving.py, one_slot)
        if self.cache is None or self.n_slots == 1:
            prompts = np.zeros((self.n_slots, self.prompt_len), np.int32)
            for i, r in enumerate(self.active):
                if r is not None:
                    p = r.prompt[-self.prompt_len:]
                    prompts[i, -len(p):] = p
            logits, self.cache = self._prefill(self.params,
                                               {"tokens": prompts})
            self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            self._knob = None   # fresh cache: actuate on the next plan
            return
        for i in admitted:
            prompt = np.zeros((1, self.prompt_len), np.int32)
            p = self.active[i].prompt[-self.prompt_len:]
            prompt[0, -len(p):] = p
            row_logits, row = self._prefill(self.params, {"tokens": prompt})
            self._lane_write(self.cache, row, self.tokens, row_logits, i)

    def _apply_knob(self, knob):
        """Write the controller-chosen TAF threshold into the decode cache:
        a tensor write, never a rebuild. `None` (precise) writes 0.0 AND
        cancels in-flight predictions ("remaining"), making a hard fallback
        effective on the next token."""
        val = 0.0 if knob is None else float(knob)
        if self.cache is None or val == self._knob:
            return
        from ..qos import set_decode_threshold
        set_decode_threshold(self.cache, val)
        prev = self._knob
        self._knob = val
        # admission re-prefills rebuild the cache and force a re-apply of
        # the SAME value; only genuine value changes are knob moves
        if not self.knob_events or self.knob_events[-1].value != val:
            self.stats.knob_moves += 1
            last = (self.knob_events[-1].value if self.knob_events
                    else prev)
            move = KnobMove(tick=self.stats.ticks, value=val,
                            previous=last,
                            reason=self._knob_reason(val, last))
            self.knob_events.append(move)
            trace.event("knob_move", tick=move.tick, value=move.value,
                        previous=move.previous, reason=move.reason)

    def tick(self) -> int:
        """One engine step: admit, decode one token for all active slots,
        retire finished requests. Returns number of live slots.

        The obs hooks below are host-side timers and event appends only:
        they never add a device read or build a step (pinned by the tests
        and by `benchmarks/obs_overhead.py`)."""
        tr_on = trace.enabled()
        rec = obs_recorder.get_recorder()
        t_tick = time.perf_counter() if (tr_on or rec is not None) else 0.0
        with trace.span("engine.tick", tick=self.stats.ticks):
            with trace.span("tick.admit"):
                self._admit()
            live = [i for i, r in enumerate(self.active) if r is not None]
            if not live:
                return 0
            lane_classes = []
            if self.qos is not None:
                lane_classes = [self.active[i].qos_class for i in live]
                with trace.span("tick.actuate"):
                    plan = self.qos.plan_tick(lane_classes)
                    self._apply_knob(plan.knob)
            pos = int(self.pos[live].min())  # single shared timeline pos
            canary = self.qos is not None and self.qos.should_sample()
            exact_logits = None
            if canary:
                # the precise oracle from the SAME pre-tick state, before
                # the served step overwrites position pos
                with trace.span("tick.canary"):
                    _, exact_logits, _ = self._serve_exact(
                        self.params, self.cache, self.tokens, pos)
            with trace.span("tick.serve", live=len(live)):
                self.tokens, logits, self.cache = self._serve(
                    self.params, self.cache, self.tokens, pos)
            if canary:
                # score ONLY the live lanes: idle or retired slots hold
                # stale state nobody consumes
                with trace.span("tick.canary"):
                    pair = torch.stack([exact_logits, logits]).cpu().numpy()
                    obs_metrics.count_host_read()
                    self.qos.observe_decode(pair[0][live], pair[1][live],
                                            lane_classes)
                self.stats.canary_ticks += 1
            with trace.span("tick.host_read"):
                taf = self.cache.get("taf")
                if taf is not None:
                    both = torch.cat([self.tokens, taf["remaining"]])
                    both = both.cpu().numpy()
                    toks, rem = both[:self.n_slots], both[self.n_slots:]
                    self.stats.taf_skipped += int((rem > 0).sum())
                    self.stats.taf_total += rem.size
                else:
                    toks = self.tokens.cpu().numpy()
                obs_metrics.count_host_read()
            now = time.time()
            with trace.span("tick.retire"):
                for i in live:
                    req = self.active[i]
                    if req.first_token_at is None:
                        req.first_token_at = now
                        self.stats.ttft_s.append(now - req.submitted_at)
                    req.output.append(int(toks[i]))
                    self.pos[i] += 1
                    self.stats.tokens_out += 1
                    done = (self.pos[i] >= self.limit[i] or
                            (req.eos_id is not None
                             and toks[i] == req.eos_id))
                    if done:
                        req.finished_at = now
                        self.stats.latency_s.append(now - req.submitted_at)
                        self.active[i] = None
                        self.stats.finished += 1
            self.stats.ticks += 1
            if self.qos is not None:
                with trace.span("tick.qos_update"):
                    self.qos.update(lane_classes)
        if tr_on or rec is not None:
            dt = time.perf_counter() - t_tick
            if tr_on:
                reg = obs_metrics.registry()
                reg.histogram("serving.tick_s").observe(dt)
                reg.gauge("serving.live_lanes").set(len(live))
                reg.counter("serving.tokens_out").inc(len(live))
            if rec is not None:
                # close out the note the QoS update opened for this tick
                rec.amend(tick_s=dt, live=len(live), knob=self._knob)
        return len([r for r in self.active if r is not None])

    def run_until_drained(self, max_ticks: int = 10_000) -> EngineStats:
        for _ in range(max_ticks):
            live = self.tick()
            if live == 0 and not self.queue:
                break
        return self.stats
