"""The port's model zoo (`repro_torch.models`: every architecture of the
registry) against the JAX package on the same weights
(`convert.lm_params`) and the same seeded numpy inputs, on the CPU.

Tolerances are the dense model tests' (`tests/test_torch_models.py`):
logits and hidden states within 1e-5 of the largest value in float32 and
0.02 in bfloat16. Routing decisions (the MoE top-k experts, which
(token, slot) keeps its capacity slot) and the engine's float32 token
streams are equal. A leaf's dtype is read off the JAX forward's own
jaxpr: the dtype the JAX model multiplies it in.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.extend import core as jcore

from repro.configs import get_smoke_config as jax_smoke
from repro.core import perforation as jperf
from repro.core import types as jt
from repro.models import build as jax_build
from repro.models import mamba2 as jmamba
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core import types as tt
from repro_torch.models import build, mamba2, mla, moe, rwkv6
from repro_torch.serving import Request, ServingEngine

ARCHS = list_archs()
B, S = 2, 16
TOL = {"float32": 1e-5, "bfloat16": 0.02}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(arch, cdt="float32", **kw):
    """The JAX and the port config of `arch`'s smoke model."""
    return (dataclasses.replace(jax_smoke(arch), remat=False,
                                compute_dtype=cdt, **kw),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=cdt,
                                **kw))


def _pair(arch, cdt="float32", **kw):
    """(JAX model, its params, port model, the same params converted)."""
    cfg, tcfg = _cfgs(arch, cdt, **kw)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return (model, params, build(tcfg, device="cpu"),
            convert.lm_params(params, tcfg, device="cpu"))


def _inputs(cfg, rng, n):
    """Seeded tokens (B, n) and the stubbed frontend's embeddings, drawn
    as tests/test_models.py draws them (numpy)."""
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = (rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio_frames":
        out["frames"] = (rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def _prefix(cfg):
    """Cache positions the vlm's patch tokens take before the prompt."""
    return cfg.n_patch_tokens if cfg.frontend == "vision_patches" else 0


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _compare(model, params, tmodel, tparams):
    """hidden, prefill and three teacher-forced decode steps through both
    packages (the JAX model jitted, as its serving path runs it, unless
    the caller disabled jit): the largest relative departure of each, and
    both final caches."""
    cfg = model.cfg
    inp = _inputs(cfg, np.random.RandomState(2), S + 3)
    batch = dict(inp, tokens=inp["tokens"][:, :S])
    off = _prefix(cfg)
    max_len = off + S + 3
    errs = {"hidden": _rel(jax.jit(model.hidden)(params, _jnp(batch)),
                           tmodel.hidden(tparams, batch).float())}
    prefill = jax.jit(lambda p, b: model.prefill(p, dict(b, max_len=max_len)))
    lj, cj = prefill(params, _jnp(batch))
    lt, ct = tmodel.prefill(tparams, dict(batch, max_len=max_len))
    errs["prefill"] = _rel(lj, lt)
    decode = jax.jit(model.decode_step)
    errs["decode"] = 0.0
    for t in range(3):
        tok = inp["tokens"][:, S + t]
        lj, cj = decode(params, cj, jnp.asarray(tok), jnp.int32(off + S + t))
        lt, ct = tmodel.decode_step(tparams, ct, torch.as_tensor(tok),
                                    off + S + t)
        errs["decode"] = max(errs["decode"], _rel(lj, lt))
    return errs, cj, ct


def _spy_routes(monkeypatch):
    """Every MoE call's (probabilities, top_i) in the JAX model (through a
    debug callback, so jitted programs report too) and in the port, in
    call order."""
    jax_routes, port_routes = [], []
    top_k, route = jax.lax.top_k, moe.route

    def jax_spy(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda p, i: jax_routes.append(
            (np.asarray(p), np.asarray(i))), x, out[1], ordered=True)
        return out

    def port_spy(logits, k, cap):
        out = route(logits, k, cap)
        port_routes.append((out[4].numpy(), out[0].numpy()))
        return out

    monkeypatch.setattr(jax.lax, "top_k", jax_spy)
    monkeypatch.setattr(moe, "route", port_spy)
    return jax_routes, port_routes


def _first_flip_is_a_near_tie(jax_routes, port_routes):
    """The first routing decision the packages take apart exchanges two
    experts whose JAX probabilities lie within one bfloat16 step (2^-7
    relative) of each other: a near tie that bfloat16 rounding decides."""
    for (pj, ij), (_, it) in zip(jax_routes, port_routes):
        for g, t in np.argwhere((np.sort(ij, -1) != np.sort(it, -1)).any(-1)):
            a = np.setdiff1d(ij[g, t], it[g, t])
            b = np.setdiff1d(it[g, t], ij[g, t])
            pa, pb = pj[g, t, a].min(), pj[g, t, b].max()
            return abs(pa - pb) <= 2.0 ** -7 * max(pa, pb), (pa, pb)
    return False, "no routing decision differs"


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_prefill_decode_match_jax(arch, cdt, monkeypatch):
    """Against the jitted JAX model. In bfloat16 an MoE router near tie can
    go the other way: XLA's fused program rounds the activations in other
    places than the port (and than JAX run op by op), and a token whose
    top-k boundary lies within bfloat16's resolution then takes another
    expert. Where that happens, the first departing decision must be such
    a near tie, and the port must then agree with the JAX model run op by
    op (`jax.disable_jit`) within the same bound."""
    model, params, tmodel, tparams = _pair(arch, cdt)
    routed = model.cfg.moe is not None and cdt == "bfloat16"
    routes = _spy_routes(monkeypatch) if routed else None
    errs, cj, ct = _compare(model, params, tmodel, tparams)
    if max(errs.values()) >= TOL[cdt] and routed:
        tie, probs = _first_flip_is_a_near_tie(*routes)
        assert tie, (errs, probs)
        with jax.disable_jit():
            errs, cj, ct = _compare(model, params, tmodel, tparams)
    assert max(errs.values()) < TOL[cdt], errs
    # the caches carry the same leaves, shapes and dtypes
    jleaves = jax.tree_util.tree_flatten_with_path(cj)[0]
    assert [(_keys(p), tuple(l.shape), str(l.dtype)) for p, l in jleaves] \
        == [(p, tuple(l.shape), str(l.dtype).replace("torch.", ""))
            for p, l in _leaves(ct)]


def _keys(path):
    return tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, in JAX's flattening
    order (sorted dict keys)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# the JAX test's decode-vs-forward list (tests/test_models.py), the vlm
# with its patch prefix, and both MoE models at capacity 8.0 (no drops)
_ALONE = ["deepseek-7b", "qwen3-1.7b", "starcoder2-3b", "qwen1.5-4b",
          "rwkv6-1.6b", "zamba2-7b", "whisper-large-v3", "pixtral-12b",
          "olmoe-1b-7b", "deepseek-v3-671b"]


@pytest.mark.parametrize("arch", _ALONE)
def test_decode_matches_forward(arch):
    """The JAX check on the port alone: decode with the cache equals the
    teacher-forced forward (float32, 0.02 relative)."""
    _, cfg = _cfgs(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    inp = _inputs(cfg, np.random.RandomState(2), S + 4)
    off = _prefix(cfg)
    _, cache = model.prefill(params, dict(inp, tokens=inp["tokens"][:, :S],
                                          max_len=off + S + 4))
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    for t in range(3):
        logits, cache = model.decode_step(
            params, cache, torch.as_tensor(inp["tokens"][:, S + t]),
            off + S + t)
        h = model.hidden(params, dict(inp, tokens=inp["tokens"][:, :S + t + 2]))
        assert _rel(h[:, off + S + t] @ head, logits) < 0.02, t


# ----------------------------------------------------------------------------
# MoE routing
# ----------------------------------------------------------------------------

def _moe_case(capacity, arch="olmoe-1b-7b", seed=4):
    cfg, tcfg = _cfgs(arch)
    m = dataclasses.replace(cfg.moe, capacity_factor=capacity)
    cfg = dataclasses.replace(cfg, moe=m)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity))
    p = jmoe.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    hold = build(tcfg, device="cpu").hold
    tp = {k: hold(k, _t(v)) for k, v in p.items() if k != "shared"}
    if "shared" in p:
        tp["shared"] = {k: hold(k, _t(v)) for k, v in p["shared"].items()}
    x = np.random.RandomState(seed).randn(2, 32, cfg.d_model).astype(
        np.float32)
    return cfg, tcfg, p, tp, x


def _spy_jax(monkeypatch):
    """Record the JAX module's top_k and its capacity one-hot's argument
    (`where(keep, pos, cap)`) on an eager call."""
    seen = {}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(x, k):
        seen["top"] = top_k(x, k)
        return seen["top"]

    def spy_one_hot(x, n, **kw):
        seen.setdefault("one_hot", []).append((np.asarray(x), n))
        return one_hot(x, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    return seen


def _spy_port(monkeypatch):
    seen = {}
    real = moe.route

    def spy(logits, k, cap):
        seen["route"] = real(logits, k, cap)
        seen["cap"] = cap
        return seen["route"]

    monkeypatch.setattr(moe, "route", spy)
    return seen


@pytest.mark.parametrize("capacity", [1.25, 8.0])
def test_moe_routing_and_aux_equal_jax(capacity, monkeypatch):
    """top_i, the kept (token, slot)s and their capacity ranks equal the
    JAX module's; at the default capacity tokens do drop. aux within
    1e-6, out within 1e-5."""
    cfg, tcfg, p, tp, x = _moe_case(capacity)
    js, ts = _spy_jax(monkeypatch), _spy_port(monkeypatch)
    jout, jaux = jmoe.forward(p, cfg, jnp.asarray(x))
    tout, taux = moe.forward(tp, tcfg, torch.from_numpy(x))
    top_i, top_w, pos, keep, _ = ts["route"]
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(js["top"][1]))
    jw = np.asarray(js["top"][0])
    jw = jw / np.maximum(jw.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(top_w.numpy(), jw, rtol=1e-6)
    where, n = js["one_hot"][-1]
    assert n == ts["cap"] + 1
    np.testing.assert_array_equal(keep.numpy(), where < ts["cap"])
    np.testing.assert_array_equal(pos.numpy()[keep.numpy()],
                                  where[where < ts["cap"]])
    if capacity == 1.25:
        assert not keep.all(), "the default capacity must drop tokens"
    else:
        assert keep.all()
    assert abs(float(taux) - float(jaux)) < 1e-6
    assert _rel(jout, tout) < 1e-5


def test_moe_ties_break_toward_the_lower_expert(monkeypatch):
    """Router columns made equal in pairs give exact ties in every token's
    probabilities: the port picks the lower expert of each tie, as
    `lax.top_k` does, and routes and drops exactly as JAX."""
    cfg, tcfg, p, tp, x = _moe_case(1.25)
    router = np.asarray(p["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    p = dict(p, router=jnp.asarray(router))
    tp = dict(tp, router=_t(router))
    js, ts = _spy_jax(monkeypatch), _spy_port(monkeypatch)
    jout, _ = jmoe.forward(p, cfg, jnp.asarray(x))
    tout, _ = moe.forward(tp, tcfg, torch.from_numpy(x))
    top_i = ts["route"][0].numpy()
    np.testing.assert_array_equal(top_i, np.asarray(js["top"][1]))
    # k = 2 of 8 experts in tied pairs: each token takes both of one pair,
    # the even one first
    assert (top_i[..., 0] % 2 == 0).all() and \
        (top_i[..., 1] == top_i[..., 0] + 1).all()
    assert _rel(jout, tout) < 1e-5


@pytest.mark.parametrize("kind,knob", [("fini", dict(fraction=0.5)),
                                       ("small", dict(skip=2)),
                                       ("ini", dict(fraction=0.25))])
def test_expert_perforation_keeps_the_jax_experts(kind, knob, monkeypatch):
    """Under an expert-perforation spec the port keeps `kept_indices`'s
    experts (router columns and expert stacks gathered) and its output
    and routing equal the JAX module's on the kept list."""
    cfg, tcfg, p, tp, x = _moe_case(8.0)

    def spec(T):
        return T.ApproxSpec(T.Technique.PERFORATION, T.Level.BLOCK,
                            perforation=T.PerforationParams(
                                kind=T.PerforationKind(kind), **knob))

    want = jperf.kept_indices(cfg.moe.n_experts, spec(jt).perforation)
    assert 0 < len(want) < cfg.moe.n_experts
    np.testing.assert_array_equal(
        moe.kept_experts(cfg.moe.n_experts, spec(tt)), want)
    js, ts = _spy_jax(monkeypatch), _spy_port(monkeypatch)
    jout, jaux = jmoe.forward(p, cfg, jnp.asarray(x), approx=spec(jt))
    tout, taux = moe.forward(tp, tcfg, torch.from_numpy(x), approx=spec(tt))
    np.testing.assert_array_equal(ts["route"][0].numpy(),
                                  np.asarray(js["top"][1]))
    assert _rel(jout, tout) < 1e-5 and abs(float(taux) - float(jaux)) < 1e-6


# ----------------------------------------------------------------------------
# Mamba2, MLA, RWKV6 on their own
# ----------------------------------------------------------------------------

def _mamba_params(cfg, tcfg):
    p = jmamba.init_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    hold = build(tcfg, device="cpu").hold
    return p, {k: ({kk: hold(kk, _t(vv)) for kk, vv in v.items()}
                   if isinstance(v, dict) else hold(k, _t(v)))
               for k, v in p.items()}


def test_mamba2_chunked_equals_recurrent_and_jax():
    """The JAX test on the port (SSD chunked scan against the stepwise
    recurrence, 20 tokens over chunks of 8 with padding), and the port's
    output, final state and conv state against the JAX mixer's."""
    cfg, tcfg = _cfgs("zamba2-7b")
    p, tp = _mamba_params(cfg, tcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                     (2, 20, cfg.d_model)) * 0.5)
    y_full, state = mamba2.forward(tp, tcfg, _t(x), return_state=True)
    cache = mamba2.init_cache(tcfg, (), 2, torch.float32)
    ys = []
    for t in range(20):
        yt, cache = mamba2.decode_step(tp, tcfg, _t(x[:, t:t + 1]), cache)
        ys.append(yt)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(state["ssm"].numpy(), cache["ssm"].numpy(),
                               atol=1e-5)
    jy, jstate = jmamba.forward(p, cfg, jnp.asarray(x), return_state=True)
    assert _rel(jy, y_full) < 1e-5
    assert _rel(jstate["ssm"], state["ssm"]) < 1e-5
    np.testing.assert_array_equal(np.asarray(jstate["conv"]),
                                  state["conv"].numpy())


def test_mla_absorbed_decode_matches_jax():
    """The latent cache after prefill and the absorbed decode's output and
    cache, step by step against the JAX module."""
    cfg, tcfg = _cfgs("deepseek-v3-671b")
    p = jmla.init_params(jax.random.PRNGKey(5), cfg, jnp.float32)
    hold = build(tcfg, device="cpu").hold
    tp = {k: ({kk: hold(kk, _t(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else hold(k, _t(v)))
          for k, v in p.items()}
    rng = np.random.RandomState(6)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    jc = jmla.init_cache(cfg, 2, 16, jnp.float32)
    tc = mla.init_cache(tcfg, 1, 2, 16, torch.float32)
    tc = {k: v[0] for k, v in tc.items()}
    jo, jc = jmla.prefill(p, cfg, jnp.asarray(x[:, :8]), jc)
    to, tc = mla.prefill(tp, tcfg, _t(x[:, :8]), tc)
    assert _rel(jo, to) < 1e-5
    for t in range(8, 12):
        jo, jc = jmla.decode_step(p, cfg, jnp.asarray(x[:, t:t + 1]), jc,
                                  jnp.int32(t))
        to, tc = mla.decode_step(tp, tcfg, _t(x[:, t:t + 1]), tc, t)
        assert _rel(jo, to) < 1e-5, t
        for name in ("ckv", "k_rope"):
            assert _rel(jc[name], tc[name]) < 1e-5, name


def test_rwkv6_wkv_scan_matches_jax():
    """The per-token WKV loop against the JAX `lax.scan`, from a nonzero
    state: outputs and final state."""
    rng = np.random.RandomState(7)
    b, s, h, hp = 2, 9, 3, 8
    r, k, v = (rng.randn(b, s, h, hp).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, s, h, hp)).astype(np.float32)
    u = rng.randn(h, hp).astype(np.float32)
    state = rng.randn(b, h, hp, hp).astype(np.float32)
    jy, js = jrwkv._wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                         state)))
    ty, ts = rwkv6.wkv_scan(*(_t(a) for a in (r, k, v, w, u, state)))
    assert _rel(jy, ty) < 1e-6 and _rel(js, ts) < 1e-6


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b", "rwkv6-1.6b",
                                  "deepseek-v3-671b", "starcoder2-3b",
                                  "qwen1.5-4b"])
def test_engine_streams_equal_jax(arch):
    """The port engine and the JAX engine on the same weights and the
    request trace of tests/test_serving.py (3 slots, 7 requests, lane
    splices at admission): float32 token streams and counts equal."""
    model, params, tmodel, tparams = _pair(arch)
    je = JaxEngine(model, params, slots=3, max_len=48, prompt_len=8)
    te = ServingEngine(tmodel, tparams, slots=3, max_len=48, prompt_len=8)

    def trace(R):
        rng = np.random.RandomState(0)
        return [R(uid=i, prompt=rng.randint(0, model.cfg.vocab_size, 8)
                  .astype(np.int32), max_new_tokens=5 + i) for i in range(7)]

    jreqs, treqs = trace(JaxRequest), trace(Request)
    for r in jreqs:
        je.submit(r)
    for r in treqs:
        te.submit(r)
    js, ts = je.run_until_drained(), te.run_until_drained()
    assert (ts.ticks, ts.tokens_out, ts.finished) == \
        (js.ticks, js.tokens_out, js.finished)
    assert [r.output for r in treqs] == [r.output for r in jreqs]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_taf_spec_on_moe_or_mla_decodes_precisely(arch):
    """JAX runs decode TAF only on a transformer without MLA or MoE: a TAF
    spec on these models builds no `taf` cache and decodes exactly as the
    precise model."""
    spec = tt.ApproxSpec(tt.Technique.TAF, tt.Level.BLOCK,
                         taf=tt.TAFParams(2, 4, 50.0))
    _, cfg = _cfgs(arch)
    taf = build(dataclasses.replace(cfg, approx_decode=spec), device="cpu")
    precise = build(cfg, device="cpu")
    assert not taf.taf_enabled
    params = precise.init(torch.Generator().manual_seed(0))
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (B, 9))
    outs = []
    for m in (taf, precise):
        _, cache = m.prefill(params, {"tokens": toks[:, :8], "max_len": 12})
        assert "taf" not in cache
        outs.append(m.decode_step(params, cache, torch.as_tensor(toks[:, 8]),
                                  8)[0])
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------------------------------
# the dtype rule
# ----------------------------------------------------------------------------

_FOLLOW = {"slice", "dynamic_slice", "squeeze", "reshape", "transpose",
           "broadcast_in_dim", "gather", "concatenate", "copy", "copy_p",
           "expand_dims", "rev"}


def _subjaxprs(eqn):
    """(inner jaxpr, the outer operands its inputs stand for) of a
    higher-order equation (jit, scan, while, cond, custom calls)."""
    p = eqn.params

    def jx(j):
        return j if isinstance(j, jcore.Jaxpr) else j.jaxpr

    if eqn.primitive.name == "while":
        cn, bn = p["cond_nconsts"], p["body_nconsts"]
        carry = eqn.invars[cn + bn:]
        return [(jx(p["cond_jaxpr"]), eqn.invars[:cn] + carry),
                (jx(p["body_jaxpr"]), eqn.invars[cn:cn + bn] + carry)]
    if eqn.primitive.name == "cond":
        return [(jx(b), eqn.invars[1:]) for b in p["branches"]]
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        if key in p:
            return [(jx(p[key]), eqn.invars)]
    return []


def _use_dtypes(jaxpr, n_roots):
    """For each of the first `n_roots` inputs of `jaxpr`, the dtypes the
    computation multiplies it in: a value is followed through reshapes,
    slices, gathers and into sub-computations; a cast records its target
    dtype, any other use the value's own dtype."""
    uses = [set() for _ in range(n_roots)]

    def walk(jx, origin):
        for eqn in jx.eqns:
            hits = [(i, origin[v]) for i, v in enumerate(eqn.invars)
                    if not isinstance(v, jcore.Literal) and v in origin]
            if not hits:
                continue
            subs = _subjaxprs(eqn)
            for sub, outer in subs:
                inner = {iv: origin[ov] for iv, ov in zip(sub.invars, outer)
                         if not isinstance(ov, jcore.Literal)
                         and ov in origin}
                walk(sub, inner)
                if len(sub.outvars) == len(eqn.outvars):
                    for iv, ov in zip(sub.outvars, eqn.outvars):
                        if not isinstance(iv, jcore.Literal) and iv in inner:
                            origin[ov] = inner[iv]
            name = eqn.primitive.name
            if subs:
                continue
            if name == "convert_element_type":
                for _, r in hits:
                    uses[r].add(str(eqn.params["new_dtype"]))
            elif name in _FOLLOW:
                for _, r in hits:
                    for ov in eqn.outvars:
                        origin[ov] = r
            else:
                for i, r in hits:
                    uses[r].add(str(eqn.invars[i].aval.dtype))

    walk(jaxpr, {v: i for i, v in enumerate(jaxpr.invars[:n_roots])})
    return uses


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_dtypes_are_the_dtypes_jax_multiplies_in(arch):
    """Each port leaf, after `init` and after `convert.lm_params`, has the
    dtype in which the JAX model's loss, prefill and decode step use it
    (bfloat16 compute, float32 params): float32 for the router, w0, u,
    A_log, D, dt_bias and the norms, bfloat16 for every other leaf."""
    cfg, tcfg = _cfgs(arch, "bfloat16", unroll_layers=True)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    batch = _jnp(_inputs(cfg, rng, 8))
    batch["labels"] = batch["tokens"]
    cache = model.init_cache(B, 40)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    uses = [set() for _ in leaves]
    for fn in (lambda p: model.loss(p, batch),
               lambda p: model.prefill(p, dict(batch, max_len=40)),
               lambda p: model.decode_step(p, cache, batch["tokens"][:, 0],
                                           jnp.int32(30))):
        closed = jax.make_jaxpr(lambda *ls: fn(jax.tree_util.tree_unflatten(
            treedef, ls)))(*[l for _, l in leaves])
        for u, got in zip(uses, _use_dtypes(closed.jaxpr, len(leaves))):
            u.update(got)
    want = {}
    for (path, _), u in zip(leaves, uses):
        assert len(u) == 1, (path, u)
        want[_keys(path)] = u.pop()
    assert {k[-1] for k, d in want.items() if d == "float32"} - \
        {"scale", "bias"} <= {"router", "w0", "u", "A_log", "D", "dt_bias"}
    tmodel = build(tcfg, device="cpu")
    for tree in (tmodel.init(torch.Generator().manual_seed(0)),
                 convert.lm_params(params, tcfg, device="cpu")):
        got = {}
        for path, leaf in _leaves(tree):
            key = tuple(k for k in path if isinstance(k, str))
            got.setdefault(key, set()).add(
                str(leaf.dtype).replace("torch.", ""))
        assert got == {k: {d} for k, d in want.items()}
