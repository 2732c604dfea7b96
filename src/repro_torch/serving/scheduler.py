"""Continuous-batching serving loop (port of `repro.serving.scheduler`, one
device).

A slot-based scheduler multiplexes many requests over one decode-step
function. Requests enter a FIFO queue; free slots are filled by per-slot
prefill; every engine tick decodes ONE token for ALL active slots;
finished sequences (EOS or max_tokens) free their slot at once -- no
head-of-line blocking on long generations.

Every family of the registry serves here but the vlm and audio ones,
whose prompts need their frontend's embeddings (the JAX engine prefills
tokens only); `launch.serve` serves those. Cache surgery walks the cache
tree to any depth and reads each leaf's batch axis from
`models.lm.CACHE_BATCH_AXES` by its path.

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

Sharded serving (`mesh=` or `devices=`, with `shards=`): `shards` logical
shards of `slots // shards` contiguous lanes each, split over the mesh's
data axes -- any multiple of their extent, so one card can run several.
Each shard carries its own TAF detector state and threshold knob, the
decode runs shard by shard (`launch.steps.make_sharded_serve_step`), and
with `qos=` the control plane actuates, canaries and updates per shard
(`QosEngine.enable_sharding`). Several ranks run SPMD: every rank runs the
same host logic on the same queue, prefills and decodes only its own
shards' lanes, and one `all_gather` a tick (the new tokens with the
`remaining` rows, and both logits on a canary tick) gives every rank the
same view, so the QoS plane runs identically everywhere.

`lint=True` runs approxlint over what the engine will serve, at
construction: the QoS policy ladder (A004, its raw entries checked against
this model's structural TAF params) and the layout of every leaf already
placed (A005); a finding raises ValueError.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from ..core.types import ApproxSpec
from ..launch import steps as steps_mod
from ..models.lm import CACHE_BATCH_AXES, Model, build, map_cache
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace
from ..obs.metrics import percentile as _percentile

# the families whose prompts carry a stubbed frontend's embeddings
FRONTEND_INPUTS = {"vlm": "patch_embeds", "audio": "frames"}


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

    `value`/`previous` are the threshold actually written -- a float, or
    a per-shard tuple on sharded engines (`previous` is None for the
    first actuation). `reason` classifies the move from the controller
    state and the value delta: init | tighten | loosen | fallback |
    mixed. Emitted as an obs `knob_move` event when tracing."""
    tick: int
    value: object
    previous: object
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
    # sharded engines: skipped / total layer-steps of each shard
    shard_taf_skipped: List[int] = dataclasses.field(default_factory=list)
    shard_taf_total: List[int] = dataclasses.field(default_factory=list)

    @property
    def taf_skip_fraction(self) -> float:
        return self.taf_skipped / max(self.taf_total, 1)

    @property
    def shard_skip_fractions(self) -> List[float]:
        return [k / max(n, 1) for k, n in zip(self.shard_taf_skipped,
                                               self.shard_taf_total)]

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
    the model's device.

    Sharded mode (`mesh=` a `DeviceMesh`, or `devices=N` for the (N, 1)
    data mesh of `runtime.elastic.data_mesh_for`, which needs the default
    process group up with world size N): `shards` logical shards (the
    mesh's data extent by default) of `slots // shards` contiguous lanes
    each. Logical shards are decoupled from the device count, so the same
    engine config gives the same outputs on one rank and on several. Each
    shard carries its own TAF detector state and threshold knob; with
    `qos=`, the control plane is switched to per-shard actuation
    (`QosEngine.enable_sharding`) and every tick plans, canaries and
    updates per shard.
    """

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 256, prompt_len: int = 32, qos=None,
                 mesh=None, devices: Optional[int] = None,
                 shards: Optional[int] = None, lint: bool = False):
        if model.cfg.family in FRONTEND_INPUTS:
            raise ValueError(
                f"{model.cfg.name}: the engine prefills prompts of tokens "
                f"only, and a {model.cfg.family} model needs its "
                f"frontend's {FRONTEND_INPUTS[model.cfg.family]!r} with "
                "every prompt (as the JAX engine, which cannot serve it "
                "either); serve it through launch.serve")
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
        if devices is not None and mesh is None:
            from ..runtime import elastic
            mesh = elastic.data_mesh_for(devices, device=model.device)
        self.mesh = mesh
        n_data, data_index = 1, 0
        if mesh is not None:
            from ..runtime import sharding as shardlib
            n_data = shardlib.data_extent(mesh)
            data_index = shardlib.data_index(mesh)
            other = {a: n for a, n in shardlib.mesh_shape(mesh).items()
                     if a not in shardlib.data_axes(mesh) and n != 1}
            if other:
                raise ValueError(f"the serving mesh is data-parallel only; "
                                 f"axes {other} must have size 1")
            da = shardlib.data_axes(mesh)
            self._group = mesh.get_group(da[0]) if len(da) == 1 else None
            self.n_shards = int(shards) if shards is not None else n_data
            if self.n_shards < 1 or self.n_shards % n_data:
                raise ValueError(
                    f"shards ({self.n_shards}) must be a positive multiple "
                    f"of the mesh's data extent ({n_data})")
            if slots % self.n_shards:
                raise ValueError(
                    f"slots ({slots}) must divide evenly into "
                    f"{self.n_shards} shards")
        else:
            if shards not in (None, 1):
                raise ValueError(
                    "shards needs a mesh (pass devices=1 for a "
                    "single-device data-parallel mesh)")
            self.n_shards = 1
        self.lanes_per_shard = slots // self.n_shards
        self._n_data = n_data
        # this rank's shards [s_lo, s_hi) and lanes [lo, hi)
        self.local_shards = self.n_shards // n_data
        self._s_lo = data_index * self.local_shards
        self._lo = self._s_lo * self.lanes_per_shard
        self._hi = self._lo + self.local_shards * self.lanes_per_shard
        self._prefill = steps_mod.make_prefill_step(model, max_len)
        if mesh is not None:
            self._serve = steps_mod.make_sharded_serve_step(
                model, mesh, self.n_shards, slots)
        else:
            self._serve = steps_mod.make_serve_step(model)
        self.cache = None
        self.tokens = torch.zeros((self._hi - self._lo,), dtype=torch.int32,
                                  device=model.device)
        self.qos = qos
        self._knob = None                    # last actuated threshold(s)
        self.knob_events: List[KnobMove] = []
        self._serve_exact = None
        if qos is not None:
            if not model.taf_enabled:
                raise ValueError(
                    "QoS-controlled serving needs decode-time TAF: build "
                    "the model with cfg.approx_decode = a TAF spec, on a "
                    "transformer without MLA or MoE (the threshold is the "
                    "online actuator)")
            # the actuator writes ONLY the threshold, so every rung must
            # describe THIS model's decode step
            from ..qos import validate_ladder_taf
            validate_ladder_taf(qos.policy, model.cfg.approx_decode.taf)
            # the canary oracle: the SAME params through a precise decode
            # step; the cache's 'taf' entry rides through it untouched. A
            # sharded engine runs it through the same sharded wrapper, so
            # its lanes run in the same groups as the served step's.
            exact_model = build(dataclasses.replace(
                model.cfg, approx_decode=ApproxSpec()), device=model.device)
            if mesh is not None:
                self._serve_exact = steps_mod.make_sharded_serve_step(
                    exact_model, mesh, self.n_shards, slots)
                qos.enable_sharding(self.n_shards)
            else:
                self._serve_exact = steps_mod.make_serve_step(exact_model)

        if lint:
            from ..analysis import rules as lint_rules
            findings = []
            if qos is not None:
                t = model.cfg.approx_decode.taf
                findings += lint_rules.check_policy_document(
                    qos.policy.to_json(), subject="engine.policy",
                    model_taf=(t.history_size, t.prediction_size))
            findings += lint_rules.check_engine_placement(self)
            if findings:
                raise ValueError(
                    "approxlint found serving misconfigurations: "
                    + "; ".join(f"{f.rule} {f.subject}: {f.message}"
                                for f in findings))

    @property
    def knob_log(self) -> List[tuple]:
        """`(tick, value)` view of `knob_events`."""
        return [(m.tick, m.value) for m in self.knob_events]

    @property
    def host_reads_per_tick(self) -> int:
        """Device reads a tick makes outside canaries: the tokens (with
        the TAF `remaining` rows), and the TAF decode step's own read."""
        return 2 if self.model.taf_enabled else 1

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def mesh_shape(self) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return tuple(int(n) for n in self.mesh.shape)

    def _lane_shard(self, lane: int) -> int:
        """Shards are contiguous lane ranges: lane -> owning shard."""
        return lane // self.lanes_per_shard

    @property
    def _admit_width(self) -> int:
        """Admission batch width: how many arriving requests of one shard
        one prefill + one cache splice covers. Lanes-per-shard, capped
        BELOW the full batch (as the JAX engine's), so an unsharded or
        one-shard engine admits request by request."""
        return (self.lanes_per_shard
                if self.lanes_per_shard < self.n_slots else 1)

    def _knob_reason(self, val, prev) -> str:
        """Classify an actuator write from controller state + the value
        delta. The plan's knob realizes decisions the controllers took at
        the END of the previous tick, so `in_fallback` is current here."""
        if prev is None:
            return "init"
        if self.qos is not None and any(
                c.in_fallback for c in self.qos.controllers.values()):
            return "fallback"
        old = prev if isinstance(prev, tuple) else (prev,)
        new = val if isinstance(val, tuple) else (val,)
        if len(old) != len(new):            # resharding edge: no delta
            return "init"
        up = any(n > o for o, n in zip(old, new))
        down = any(n < o for o, n in zip(old, new))
        if up and down:
            return "mixed"
        # lower TAF threshold => fewer skips => more precise
        return "tighten" if down else "loosen"

    def _lane_write(self, cache, rows, tokens, row_logits, lanes):
        """Splice a batch-W prefill into the live cache in place: row j
        goes to local lane `lanes[j]`. Each leaf's batch axis is named in
        `models.lm.CACHE_BATCH_AXES`; leaves without one (the detector
        state, the knob thresholds) keep their LIVE values: admission does
        not reset another lane's quality state or the actuated knob."""
        def splice(path, live, r):
            axis = CACHE_BATCH_AXES[path]
            if axis is not None:
                for j, lane in enumerate(lanes):
                    live.select(axis, lane).copy_(r.select(axis, j))

        map_cache(splice, cache, rows)
        new = torch.argmax(row_logits, dim=-1).to(tokens.dtype)
        for j, lane in enumerate(lanes):
            tokens[lane:lane + 1].copy_(new[j:j + 1])

    def _prefill_local(self, prompts):
        """Prefill this rank's lanes of the (slots, prompt_len) `prompts`.
        A sharded engine prefills shard by shard (so a shard's cache does
        not depend on how shards are packed onto ranks) and stacks the
        shards' detector state on a leading shard dim
        (`models.lm.shard_taf_state`)."""
        if not self.sharded:
            return self._prefill(self.params, {"tokens": prompts})
        w = self.lanes_per_shard
        parts = [self._prefill(self.params, {"tokens": prompts[a:a + w]})
                 for a in range(self._lo, self._hi, w)]
        logits = torch.cat([lg for lg, _ in parts])

        def merge(path, *ts):
            axis = CACHE_BATCH_AXES[path]
            return (torch.stack(ts) if axis is None
                    else torch.cat(ts, dim=axis))

        return logits, map_cache(merge, *[c for _, c in parts])

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every data rank's `t`, in data order (one collective; just [t]
        unsharded)."""
        if self.mesh is None:
            return [t]
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self._n_data)]
        dist.all_gather(parts, t, group=self._group)
        return parts

    def warmup(self):
        """Run prefill, serve, the canary oracle, the admission path and
        the tick's collective once on throwaway state, so the first timed
        tick measures decode, not first-call setup. Engine state is
        untouched."""
        with trace.span("engine.warmup", slots=self.n_slots,
                        shards=self.n_shards):
            prompts = np.zeros((self.n_slots, self.prompt_len), np.int32)
            logits, cache = self._prefill_local(prompts)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            if self._serve_exact is not None:
                self._serve_exact(self.params, cache, tokens, self.prompt_len)
            self._serve(self.params, cache, tokens, self.prompt_len)
            if self.n_slots > 1:
                w = self._admit_width
                row_logits, rows = self._prefill(
                    self.params,
                    {"tokens": np.zeros((w, self.prompt_len), np.int32)})
                self._lane_write(cache, rows, tokens, row_logits,
                                 list(range(w)))
            self._gather(tokens)
            if self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)

    def submit(self, req: Request):
        req.submitted_at = time.time()
        self.queue.append(req)

    def _admit(self):
        """Fill free slots from the queue. The FIRST admission prefills
        the whole batch (there is no live cache yet); afterwards the
        arriving requests of a shard cost one prefill of up to
        `_admit_width` rows plus a per-lane cache splice, which leaves
        ongoing lanes' KV, detector state and the actuated knob untouched.
        Every rank admits the same requests; each prefills only those
        landing in its own lanes."""
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
            logits, self.cache = self._prefill_local(prompts)
            self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            self._knob = None   # fresh cache: actuate on the next plan
            return
        w = self._admit_width
        for s in range(self._s_lo, self._s_lo + self.local_shards):
            mine = [i for i in admitted if self._lane_shard(i) == s]
            for g in range(0, len(mine), w):
                grp = mine[g:g + w]
                prompts = np.zeros((len(grp), self.prompt_len), np.int32)
                for j, i in enumerate(grp):
                    p = self.active[i].prompt[-self.prompt_len:]
                    prompts[j, -len(p):] = p
                row_logits, rows = self._prefill(self.params,
                                                 {"tokens": prompts})
                self._lane_write(self.cache, rows, self.tokens, row_logits,
                                 [i - self._lo for i in grp])

    def _apply_knob(self, knob):
        """Write the controller-chosen TAF threshold(s) into the decode
        cache: a tensor write, never a rebuild. `None` (precise) writes 0.0
        AND cancels in-flight predictions ("remaining"), making a hard
        fallback effective on the next token. Sharded engines pass a
        per-shard sequence (`TickPlan.shard_knobs`): each value lands on
        its shard's row of the threshold leaf (this rank writes its own
        shards' rows), and only shards set precise have their predictions
        cancelled."""
        if isinstance(knob, (list, tuple)):
            val = tuple(0.0 if k is None else float(k) for k in knob)
        else:
            val = 0.0 if knob is None else float(knob)
        if self.cache is None or val == self._knob:
            return
        from ..qos import set_decode_threshold
        set_decode_threshold(
            self.cache, val[self._s_lo:self._s_lo + self.local_shards]
            if isinstance(val, tuple) else val)
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

    def _observe_canary(self, exact_logits, logits, live, lane_classes,
                        shard_classes):
        """Score a canary tick's live lanes: one gather and one host read
        of both logits, then per shard (sharded) or as one group."""
        parts = self._gather(torch.stack([exact_logits, logits]))
        pair = (parts[0] if len(parts) == 1
                else torch.cat(parts, dim=1)).cpu().numpy()
        obs_metrics.count_host_read()
        if not self.sharded:
            self.qos.observe_decode(pair[0][live], pair[1][live],
                                    lane_classes)
            return
        # per-shard attribution: each shard's slice is scored separately,
        # so a canary error is credited only to the shard (and the
        # classes) that ran under that knob
        for s in range(self.n_shards):
            lanes = [i for i in live if self._lane_shard(i) == s]
            if lanes:
                self.qos.observe_shard(s, pair[0][lanes], pair[1][lanes],
                                       shard_classes[s])

    def _read_tokens(self):
        """The tick's host read: every rank's new tokens (with the TAF
        `remaining` rows when the model runs decode TAF) in one gather and
        one read. Returns (tokens (slots,), remaining (shards, n_layers)
        or None)."""
        n_local = self._hi - self._lo
        taf = self.cache.get("taf")
        mine = self.tokens
        if taf is not None:
            mine = torch.cat([self.tokens, taf["remaining"].reshape(-1)])
        parts = self._gather(mine)
        rows = (parts[0][None] if len(parts) == 1
                else torch.stack(parts)).cpu().numpy()
        obs_metrics.count_host_read()
        toks = rows[:, :n_local].reshape(-1)
        if taf is None:
            return toks, None
        return toks, rows[:, n_local:].reshape(self.n_shards, -1)

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
            shard_classes = None
            if self.qos is not None:
                lane_classes = [self.active[i].qos_class for i in live]
                with trace.span("tick.actuate"):
                    if self.sharded:
                        shard_classes = [[] for _ in range(self.n_shards)]
                        for i in live:
                            shard_classes[self._lane_shard(i)].append(
                                self.active[i].qos_class)
                        plan = self.qos.plan_shards(shard_classes)
                        self._apply_knob(plan.shard_knobs)
                    else:
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
                    self._observe_canary(exact_logits, logits, live,
                                         lane_classes, shard_classes)
                self.stats.canary_ticks += 1
            with trace.span("tick.host_read"):
                toks, rem = self._read_tokens()
                if rem is not None:
                    self.stats.taf_skipped += int((rem > 0).sum())
                    self.stats.taf_total += rem.size
                    if self.sharded:
                        if not self.stats.shard_taf_total:
                            self.stats.shard_taf_skipped = \
                                [0] * self.n_shards
                            self.stats.shard_taf_total = [0] * self.n_shards
                        for s in range(self.n_shards):
                            self.stats.shard_taf_skipped[s] += int(
                                (rem[s] > 0).sum())
                            self.stats.shard_taf_total[s] += rem.shape[1]
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
                    if self.sharded:
                        self.qos.update_shards(shard_classes)
                    else:
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
