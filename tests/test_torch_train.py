"""The training half of the port's model zoo against the JAX package on
the same weights (`convert.lm_params(..., masters=True)` of the JAX
`model.init(PRNGKey(0))`) and the same seeded numpy batches, on the CPU.

Tolerances: in float32 the loss within 1e-5 relative of jitted JAX's and
each gradient leaf within 1e-4 (the norm of the difference over the norm
of JAX's gradient); in bfloat16 the loss within 0.02 (the forward's
bfloat16 bound in tests/test_torch_zoo.py). MoE batches fill whole router
groups.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.types import parse_pragma as jax_pragma
from repro.models import build as jax_build
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core.types import parse_pragma
from repro_torch.launch import steps
from repro_torch.models import build, common, lm, moe, rwkv6
from repro_torch.optim import adamw

ARCHS = list_archs()
B = 2
LOSS_TOL = {"float32": 1e-5, "bfloat16": 0.02}
GRAD_TOL = 1e-4


def _seq(cfg):
    """Tokens a row: an MoE batch fills one router group of the smoke
    config (2 x 32 = 64 tokens)."""
    return 32 if cfg.moe is not None else 16


def _cfgs(arch, cdt="float32", **kw):
    return (dataclasses.replace(jax_smoke(arch), compute_dtype=cdt, **kw),
            dataclasses.replace(get_smoke_config(arch), compute_dtype=cdt,
                                **kw))


def _pair(arch, cdt="float32", **kw):
    """(JAX model, its params, port model, the same params as masters)."""
    cfg, tcfg = _cfgs(arch, cdt, **kw)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return (model, params, build(tcfg, device="cpu"),
            convert.lm_params(params, tcfg, device="cpu", masters=True))


def _batch(cfg, seed=0, s=None):
    rng = np.random.RandomState(seed)
    s = s or _seq(cfg)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = (rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio_frames":
        out["frames"] = (rng.standard_normal(
            (B, cfg.max_source_positions, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted key order (JAX's pytree order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _port_grads(tmodel, masters, batch):
    """(loss, metrics, {path: grad}) of the port's loss at the masters."""
    loss, metrics, grads = steps.loss_and_grads(tmodel, masters, batch)
    order = [id(t) for t in adamw.leaves(masters)]
    by_id = dict(zip(order, grads))
    return loss, metrics, {p: by_id[id(t)] for p, t in _leaves(masters)}


def _grad_departures(jgrads, tcfg, port):
    """Each leaf's |port - JAX| / |JAX| (0 where both are 0)."""
    ref = dict(_leaves(convert.lm_params(jgrads, tcfg, device="cpu",
                                         masters=True)))
    assert ref.keys() == port.keys()
    out = {}
    for path, g in ref.items():
        d = float((port[path].double() - g.double()).norm())
        n = float(g.double().norm())
        out[path] = d / n if n > 0 else d
    return out


def _jax_value_and_grad(model, params, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, _jnp(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


# ----------------------------------------------------------------------------
# every architecture: loss and gradients
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_float32(arch):
    """The loss, its metrics (xent, the MoE aux loss, MTP's loss, the vlm's
    text positions only) and every gradient leaf against jitted JAX, with
    remat on in both packages (`jax.checkpoint` / `common.remat`)."""
    model, params, tmodel, masters = _pair(arch, remat=True)
    batch = _batch(model.cfg)
    jl, jm, jg = _jax_value_and_grad(model, params, batch)
    loss, metrics, grads = _port_grads(tmodel, masters, batch)
    assert abs(float(loss) - jl) <= LOSS_TOL["float32"] * abs(jl)
    assert metrics.keys() == jm.keys()
    for k, v in jm.items():
        assert abs(float(metrics[k]) - v) <= 1e-5 * max(abs(v), 1e-6), k
    dep = _grad_departures(jg, tmodel.cfg, grads)
    worst = max(dep, key=dep.get)
    assert dep[worst] < GRAD_TOL, (worst, dep[worst])
    assert all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax_in_bfloat16(arch):
    model, params, tmodel, masters = _pair(arch, "bfloat16")
    batch = _batch(model.cfg, seed=1)
    jl = float(jax.jit(model.loss)(params, _jnp(batch))[0])
    loss, _ = tmodel.loss(tmodel.use(masters), batch)
    assert abs(float(loss) - jl) <= LOSS_TOL["bfloat16"] * abs(jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_use_of_masters_is_init_bit_for_bit(arch):
    """`use(masters(g))` equals today's `init(g)` leaf for leaf, dtype and
    bits (pins the serving weights), and each master is in the dtype JAX
    stores it in."""
    cfg = get_smoke_config(arch)
    model = build(cfg, device="cpu")
    held = dict(_leaves(model.init(torch.Generator().manual_seed(0))))
    masters = model.masters(torch.Generator().manual_seed(0))
    used = dict(_leaves(model.use(masters)))
    assert held.keys() == used.keys()
    for path, t in held.items():
        assert used[path].dtype == t.dtype and torch.equal(used[path], t), \
            path
    jmodel = jax_build(jax_smoke(arch))
    jp = dict(_leaves(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))))
    port = dict(_leaves(masters))
    for path, t in port.items():
        jpath = next(p for p in jp if tuple(k for k in p) == tuple(
            k for k in path if isinstance(k, str)))
        assert str(t.dtype).split(".")[-1] == str(jp[jpath].dtype), path


def test_masters_receive_the_gradient_of_their_use():
    """`use` is a differentiable cast: a bfloat16 forward's gradient lands
    on the float32 master in float32, as the transpose of JAX's astype."""
    _, tcfg = _cfgs("qwen3-1.7b", "bfloat16")
    model = build(tcfg, device="cpu")
    masters = model.masters(torch.Generator().manual_seed(0))
    assert masters["embed"].dtype == torch.float32
    assert model.use(masters)["embed"].dtype == torch.bfloat16
    _, _, grads = steps.loss_and_grads(model, masters, _batch(tcfg))
    assert all(g.dtype == torch.float32 for g in grads)
    assert float(sum(g.abs().sum() for g in grads)) > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "zamba2-7b",
                                  "rwkv6-1.6b", "whisper-large-v3"])
def test_remat_recomputes_each_layer_and_changes_nothing(arch, monkeypatch):
    """Under cfg.remat the loss's layers run through
    `torch.utils.checkpoint` (the transformer's blocks, zamba2's mixers,
    the RWKV layers, whisper's encoder and decoder blocks) besides the
    head's chunks, and the loss and gradients equal the run without it."""
    _, tcfg = _cfgs(arch)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *a, **kw):
        calls.append(getattr(fn, "__name__", ""))
        return real(fn, *a, **kw)

    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = build(cfg, device="cpu")
        masters = model.masters(torch.Generator().manual_seed(0))
        calls.clear()
        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
        loss, _, grads = steps.loss_and_grads(model, masters, _batch(cfg))
        monkeypatch.undo()
        layers = [c for c in calls if c != "_chunk_nll"]
        out[remat] = (loss, grads, layers)
    cfg = tcfg
    n = cfg.n_layers * (2 if cfg.is_encdec else 1)
    if cfg.family == "hybrid":
        n_groups, mpg, _ = lm.blocks.hybrid_layout(cfg)
        n = n_groups * mpg
    assert out[False][2] == [] and len(out[True][2]) == n
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))


# ----------------------------------------------------------------------------
# the head's chunked cross-entropy
# ----------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4))
def test_chunked_xent_matches_jax(b, nc):
    """tests/test_properties.py's case against the JAX function: the sum
    and count, and the direct logsumexp form."""
    rng = np.random.RandomState(b * 7 + nc)
    s, d, v = nc * 4, 8, 16
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    y = rng.randint(0, v, (b, s))
    jt, jc = jlm.chunked_xent(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(y), chunk=4)
    tt, tc = lm.chunked_xent(torch.as_tensor(h), torch.as_tensor(w), y,
                             chunk=4)
    assert abs(float(tt) - float(jt)) <= 1e-5 * abs(float(jt))
    assert float(tc) == float(jc) == b * s
    logits = torch.as_tensor(h) @ torch.as_tensor(w)
    direct = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.as_tensor(y)[..., None])[..., 0]).sum()
    assert abs(float(tt) - float(direct)) <= 1e-4 * abs(float(direct))


def test_chunked_xent_halves_the_chunk_and_masks_as_jax():
    """S = 12 with chunk 8 halves to 4 (three chunks); a mask weights each
    position's nll and is the count; gradients of h and w against JAX."""
    rng = np.random.RandomState(3)
    h = rng.standard_normal((2, 12, 8)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.randint(0, 16, (2, 12))
    mask = (rng.uniform(size=(2, 12)) > 0.3).astype(np.float32)

    def jf(h, w):
        return jlm.chunked_xent(h, w, jnp.asarray(y), jnp.asarray(mask),
                                chunk=8)

    (jt, jc), jvjp = jax.vjp(jf, jnp.asarray(h), jnp.asarray(w))
    jgh, jgw = jvjp((jnp.float32(1), jnp.float32(0)))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    chunks = []
    real = lm._chunk_nll

    def spy(hc, *a):
        chunks.append(hc.shape[1])
        return real(hc, *a)

    lm._chunk_nll = spy
    try:
        tt, tc = lm.chunked_xent(th, tw, y, torch.as_tensor(mask), chunk=8)
    finally:
        lm._chunk_nll = real
    assert chunks == [4, 4, 4]
    assert float(tc) == float(jc) == float(mask.sum())
    assert abs(float(tt) - float(jt)) <= 1e-5 * abs(float(jt))
    gh, gw = torch.autograd.grad(tt, (th, tw))
    for a, b in ((gh, jgh), (gw, jgw)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 1e-5 * np.linalg.norm(b)


# ----------------------------------------------------------------------------
# module gradients
# ----------------------------------------------------------------------------

def test_moe_forward_gradients_match_jax():
    """The MoE layer's dispatch writes its (g, E*C+1, d) buffer with
    `scatter_` into a fresh zeros tensor, which autograd allows: the
    output's and the aux loss's gradients of x and of every expert leaf
    against the JAX module, at capacity 1.25 (tokens drop)."""
    cfg, tcfg = _cfgs("olmoe-1b-7b")
    jp = jmoe.init_params(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def jf(p, x):
        out, aux = jmoe.forward(p, cfg, x)
        return jnp.sum(out * cot) + 10.0 * aux

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: (torch.tensor(np.asarray(v), requires_grad=True)
              if not isinstance(v, dict) else
              {kk: torch.tensor(np.asarray(vv), requires_grad=True)
               for kk, vv in v.items()})
          for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.forward(tp, tcfg, tx)
    (torch.sum(out * torch.as_tensor(cot)) + 10.0 * aux).backward()
    pairs = [(tx.grad, jgx)] + [(tp[k].grad, jgp[k]) for k in
                                ("router", "w_gate", "w_up", "w_down")]
    for a, b in pairs:
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= GRAD_TOL * np.linalg.norm(b)


def test_rwkv6_layer_forward_writes_nothing():
    """`layer_forward` returns the new state and leaves the state it read
    untouched (autograd saved it); `write_state` is the cache's writer."""
    cfg = get_smoke_config("rwkv6-1.6b")
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(B)
    view = lm.layer_view(cache, 0)
    view["wkv"].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: t.clone() for k, t in view.items()}
    x = torch.randn(B, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2)).to(model.cdt)
    _, state = rwkv6.layer_forward(params["layers"][0], cfg, x, view)
    assert all(torch.equal(view[k], before[k]) for k in view)
    rwkv6.write_state(view, state)
    assert all(torch.equal(view[k], state[k].to(view[k].dtype))
               for k in view)


# ----------------------------------------------------------------------------
# perforated training
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("attn,ffn", [("perfo(ini:0.5)", "perfo(small:4)")])
def test_perforated_training_matches_jax(attn, ffn):
    """tests/test_perf_features.py's perforated deepseek-7b (herded KV
    blocks, hidden-dim blocks): loss and gradients against JAX at the
    float32 tolerances."""
    cfg, tcfg = _cfgs("deepseek-7b", remat=False,
                      approx_attention=jax_pragma(attn),
                      approx_ffn=jax_pragma(ffn))
    tcfg = dataclasses.replace(tcfg, approx_attention=parse_pragma(attn),
                               approx_ffn=parse_pragma(ffn))
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, device="cpu")
    masters = convert.lm_params(params, tcfg, device="cpu", masters=True)
    batch = _batch(cfg, seed=2, s=256)
    jl, _, jg = _jax_value_and_grad(model, params, batch)
    loss, _, grads = _port_grads(tmodel, masters, batch)
    assert abs(float(loss) - jl) <= LOSS_TOL["float32"] * abs(jl)
    dep = _grad_departures(jg, tcfg, grads)
    worst = max(dep, key=dep.get)
    assert dep[worst] < GRAD_TOL, (worst, dep[worst])
    # the perforation took effect: the precise model's loss differs
    precise = build(dataclasses.replace(
        tcfg, approx_attention=parse_pragma("none"),
        approx_ffn=parse_pragma("none")), device="cpu")
    assert abs(float(precise.loss(precise.use(masters), batch)[0])
               - float(loss)) > 1e-4


def test_common_remat_is_a_plain_call_without_autograd():
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return x * 2

    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(common.remat(True, fn, x), 2 * x.detach())
    assert calls == [False]
