"""The port's dense LM (`repro_torch.models`) against the JAX model on the
same weights (`convert.lm_params`) and the same numpy inputs, on the CPU.

Tolerances: logits and hidden states within 1e-5 of the largest value in
float32 and 0.02 in bfloat16 (the JAX decode-vs-forward test's bound;
bfloat16 rounds each op in another place in the two packages). The int8 KV
path quantizes values that differ in the last float32 bits, so a row
element on a rounding boundary can land one int8 level apart: at most one
level, on at most 0.1% of the cache, and logits within 1e-3. Decode-time
TAF decisions (`remaining`) are equal step by step.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import types as jt
from repro.models import build as jax_build
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import types as tt
from repro_torch.models import blocks, build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.qos import set_decode_threshold

B, S = 2, 16
TOL = {"float32": 1e-5, "bfloat16": 0.02}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-6))


def _pair(arch="qwen3-1.7b", jax_kw=None, torch_kw=None, cdt="float32"):
    """(JAX model, its params, port model, the same params converted)."""
    cfg = dataclasses.replace(jax_smoke(arch), remat=False,
                              compute_dtype=cdt, **(jax_kw or {}))
    tcfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=cdt,
                               **(torch_kw or {}))
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = build(tcfg, device="cpu")
    return model, params, tmodel, convert.lm_params(params, tcfg,
                                                     device="cpu")


def _taf(T, threshold):
    return T.ApproxSpec(T.Technique.TAF, T.Level.BLOCK,
                        taf=T.TAFParams(2, 4, threshold))


def _perfo(T, kind, fraction):
    return T.ApproxSpec(T.Technique.PERFORATION, T.Level.BLOCK,
                        perforation=T.PerforationParams(
                            kind=T.PerforationKind(kind), fraction=fraction))


def _tokens(cfg, seed, n):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _jitted(model, max_len):
    """The JAX model's prefill and decode step under jit (as the JAX
    serving path runs them)."""
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t,
                                                     "max_len": max_len}))
    return prefill, jax.jit(model.decode_step)


def _run_both(model, params, tmodel, tparams, s, steps=3, seed=2):
    """hidden, prefill and `steps` teacher-forced decode steps through
    both packages: the largest relative departure of each, and both final
    caches."""
    toks = _tokens(model.cfg, seed, s + steps + 1)
    out = {"hidden": _rel(
        jax.jit(model.hidden)(params, {"tokens": jnp.asarray(toks[:, :s])}),
        tmodel.hidden(tparams, {"tokens": toks[:, :s]}).float())}
    prefill, decode = _jitted(model, s + steps + 1)
    lj, cj = prefill(params, jnp.asarray(toks[:, :s]))
    lt, ct = tmodel.prefill(tparams, {"tokens": toks[:, :s],
                                      "max_len": s + steps + 1})
    out["prefill"] = _rel(lj, lt)
    out["decode"] = 0.0
    for t in range(steps):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, s + t]),
                        jnp.int32(s + t))
        lt, ct = tmodel.decode_step(tparams, ct,
                                    torch.as_tensor(toks[:, s + t]), s + t)
        out["decode"] = max(out["decode"], _rel(lj, lt))
    return out, cj, ct


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-7b"])
def test_hidden_prefill_decode_match_jax(arch, cdt):
    errs, _, _ = _run_both(*_pair(arch, cdt=cdt), S)
    assert max(errs.values()) < TOL[cdt], errs


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-7b"])
def test_decode_matches_forward(arch):
    """The JAX test's check on the port alone: greedy decode with the KV
    cache equals the teacher-forced forward (float32, 0.02 relative)."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = _tokens(cfg, 2, S + 4)
    _, cache = model.prefill(params, {"tokens": toks[:, :S],
                                      "max_len": S + 4})
    for t in range(3):
        logits, cache = model.decode_step(
            params, cache, torch.as_tensor(toks[:, S + t]), S + t)
        h = model.hidden(params, {"tokens": toks[:, :S + t + 2]})
        assert _rel(h[:, S + t] @ params["head"], logits) < 0.02


def test_int8_kv_path_matches_jax():
    errs, cj, ct = _run_both(*_pair(jax_kw=dict(kv_cache_dtype="int8"),
                                    torch_kw=dict(kv_cache_dtype="int8")), S)
    assert errs["hidden"] < 1e-5 and errs["prefill"] < 1e-5
    assert errs["decode"] < 1e-3, errs
    for name in ("k", "v"):
        kj = np.asarray(cj["dense"][name]).astype(np.int32)
        kt = ct["dense"][name].numpy().astype(np.int32)
        assert ct["dense"][name].dtype == torch.int8
        assert np.abs(kj - kt).max() <= 1
        assert (kj != kt).mean() <= 1e-3
    np.testing.assert_array_equal(
        np.asarray(cj["dense"]["k_scale"].astype(jnp.float32)),
        ct["dense"]["k_scale"].float().numpy())


@pytest.mark.parametrize("attn,ffn", [
    (("fini", 0.5), ("ini", 0.5)), (("ini", 0.5), None),
    (None, ("fini", 0.25))])
def test_perforated_attention_and_ffn_specs_match_jax(attn, ffn):
    """Herded KV-block and d_ff-block perforation: 260 positions are two
    whole 128-blocks and a tail the prefill drops, d_ff 512 four blocks."""
    def kw(T):
        return dict(d_ff=512,
                    approx_attention=_perfo(T, *attn) if attn
                    else T.ApproxSpec(),
                    approx_ffn=_perfo(T, *ffn) if ffn else T.ApproxSpec())
    errs, _, _ = _run_both(*_pair(jax_kw=kw(jt), torch_kw=kw(tt)), 260)
    assert max(errs.values()) < 1e-5, errs


@pytest.mark.parametrize("arch,threshold,cdt", [
    ("deepseek-7b", 50.0, "float32"),    # the JAX test's skipping config
    ("qwen3-1.7b", 0.5, "float32"),      # default_decode_cfg's threshold
    ("qwen3-1.7b", 50.0, "bfloat16"),
])
def test_taf_decode_decisions_match_jax_step_by_step(arch, threshold, cdt):
    """Skip decisions and `remaining` equal at every step, with JAX's own
    greedy tokens fed to both. The port's per-layer batch mean differs
    from XLA's in the last bits (the layer outputs do), so the decisions,
    not the window values, are what is held equal."""
    model, params, tmodel, tparams = _pair(
        arch, jax_kw=dict(approx_decode=_taf(jt, threshold)),
        torch_kw=dict(approx_decode=_taf(tt, threshold)), cdt=cdt)
    toks = _tokens(model.cfg, 5, 8)
    prefill, decode = _jitted(model, 24)
    _, cj = prefill(params, jnp.asarray(toks))
    _, ct = tmodel.prefill(tparams, {"tokens": toks, "max_len": 24})
    tok = toks[:, -1]
    h = model.cfg.approx_decode.taf.history_size
    skipped = stable = unstable = 0
    computed = np.ones(model.cfg.n_layers, bool)
    for t in range(12):
        lj, cj = decode(params, cj, jnp.asarray(tok), jnp.int32(8 + t))
        lt, ct = tmodel.decode_step(tparams, ct, torch.as_tensor(tok), 8 + t)
        rem = np.asarray(cj["taf"]["remaining"])
        np.testing.assert_array_equal(ct["taf"]["remaining"].numpy(), rem)
        np.testing.assert_array_equal(ct["taf"]["filled"].numpy(),
                                      np.asarray(cj["taf"]["filled"]))
        assert _rel(lj, lt) < TOL[cdt]
        assert np.isfinite(lt.numpy()).all()
        skipped += int((rem > 0).sum())
        # a computed layer with a full window held its RSD to the threshold
        decided = computed & (np.asarray(cj["taf"]["filled"]) >= h)
        stable += int((decided & (rem > 0)).sum())
        unstable += int((decided & (rem == 0)).sum())
        computed = rem == 0
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    if threshold == 50.0:
        assert skipped > 0, "a huge threshold must skip layer-steps"
    if cdt == "float32":
        # decisions both ways: layers that went stable beside layers whose
        # RSD stayed over the same threshold, so `remaining` is held equal
        # on mixed decisions and not only on a regime every layer shares
        assert stable > 0 and unstable > 0, (stable, unstable)


def _count_block_decodes(monkeypatch):
    calls = []
    real = blocks.block_decode

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(blocks, "block_decode", counted)
    return calls


def test_skipped_layers_compute_nothing_and_a_step_reads_once(monkeypatch):
    """A decode step reads `remaining` from the device once, and a layer
    whose `remaining` is positive at the step's start runs no block
    computation; a hard fallback (threshold 0) makes the next step compute
    every layer."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"),
                              compute_dtype="float32",
                              approx_decode=_taf(tt, 50.0))
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = _tokens(cfg, 5, 8)
    _, cache = model.prefill(params, {"tokens": toks, "max_len": 24})
    calls = _count_block_decodes(monkeypatch)
    tok = torch.as_tensor(toks[:, -1])
    skipped = 0
    for t in range(8):
        rem = cache["taf"]["remaining"].clone()
        reads, n0 = obs_metrics.host_reads(), len(calls)
        logits, cache = model.decode_step(params, cache, tok, 8 + t)
        assert obs_metrics.host_reads() - reads == 1
        assert len(calls) - n0 == int((rem == 0).sum())
        skipped += int((rem > 0).sum())
        tok = torch.argmax(logits, -1).to(torch.int32)
    assert skipped > 0
    set_decode_threshold(cache, 0.0)
    assert int(cache["taf"]["remaining"].sum()) == 0
    n0 = len(calls)
    model.decode_step(params, cache, tok, 16)
    assert len(calls) - n0 == cfg.n_layers
    assert int(cache["taf"]["remaining"].sum()) == 0


def test_skipped_layer_writes_its_stale_kv_at_pos():
    """A skipped layer's K/V at the decoded position is its memoized row
    (the JAX approx branch's dynamic_update_slice)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"),
                              compute_dtype="float32",
                              approx_decode=_taf(tt, 50.0))
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    toks = _tokens(cfg, 6, 8)
    _, cache = model.prefill(params, {"tokens": toks, "max_len": 24})
    tok = torch.as_tensor(toks[:, -1])
    for t in range(12):
        skip = (cache["taf"]["remaining"] > 0).clone()
        memo_k = cache["taf"]["memo_k"].clone()
        logits, cache = model.decode_step(params, cache, tok, 8 + t)
        for l in torch.nonzero(skip).flatten().tolist():
            assert torch.equal(cache["dense"]["k"][l][:, :, 8 + t],
                               memo_k[l][:, :, 0])
        tok = torch.argmax(logits, -1).to(torch.int32)


def test_configs_and_build_refuse_what_is_not_ported():
    full = get_config("qwen3-1.7b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size, full.tie_embeddings) == \
        (28, 2048, 16, 8, 6144, 151936, False)
    assert full.param_count() == jax_config("qwen3-1.7b").param_count()
    for arch in ("zamba2-7b", "olmoe-1b-7b", "whisper-large-v3"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            get_smoke_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-17")
    moe = dataclasses.replace(get_smoke_config("qwen3-1.7b"), family="moe")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        build(moe, device="cpu")


def _xla_tree_sum(x):
    """XLA's CPU order for a float32 (B, d) -> () sum, d a multiple of 32:
    windows of B x 32 columns, each summed in row order, then groups of 32
    windows, then the rest, each in index order."""
    def seq(v):
        acc = np.float32(0)
        for e in np.asarray(v, np.float32).ravel():
            acc = np.float32(acc + e)
        return acc
    w = np.array([seq(x[:, c:c + 32]) for c in range(0, x.shape[1], 32)],
                 np.float32)
    while w.size > 32:
        w = np.array([seq(w[i:i + 32]) for i in range(0, w.size, 32)],
                     np.float32)
    return seq(w)


def test_xla_sums_the_batch_mean_in_column_windows():
    """The finding behind decode TAF's batch mean: XLA's `jnp.mean` of a
    (B, d) float32 delta is the column-window tree sum times float32(1/n),
    bit for bit; the port does not copy that order because the deltas it
    would sum already differ from XLA's in the last bits."""
    rng = np.random.RandomState(0)
    mean = jax.jit(jnp.mean)
    for shape in ((2, 64), (3, 64), (4, 2048)):
        for _ in range(5):
            x = (rng.randn(*shape) * 0.1 + rng.randn() * 0.01).astype(
                np.float32)
            assert np.float32(mean(x)) == \
                _xla_tree_sum(x) * np.float32(1.0 / x.size)
    model, params, tmodel, tparams = _pair(
        "deepseek-7b", jax_kw=dict(approx_decode=_taf(jt, 50.0)),
        torch_kw=dict(approx_decode=_taf(tt, 50.0)))
    toks = _tokens(model.cfg, 5, 8)
    prefill, decode = _jitted(model, 12)
    _, cj = prefill(params, jnp.asarray(toks))
    _, ct = tmodel.prefill(tparams, {"tokens": toks, "max_len": 12})
    _, cj = decode(params, cj, jnp.asarray(toks[:, -1]), jnp.int32(8))
    tmodel.decode_step(tparams, ct, torch.as_tensor(toks[:, -1]), 8)
    dj = np.asarray(cj["taf"]["memo_delta"])
    dt = ct["taf"]["memo_delta"].numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-5)
    assert not np.array_equal(dt, dj)


def test_common_functions_match_jax():
    """The shared math on the same numpy inputs: rms / layer norm, RoPE,
    chunked attention (several chunks, GQA, herded `kv_positions`), full
    and decode attention, and the GELU FFN the dense configs do not use."""
    from repro.models import common as jc
    from repro.models import mlp as jmlp
    from repro_torch.models import common as tc
    from repro_torch.models import mlp as tmlp
    rng = np.random.RandomState(11)

    def arr(*shape):
        return rng.randn(*shape).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    x, scale, bias = arr(2, 5, 16), arr(16), arr(16)
    assert _rel(jc.rmsnorm({"scale": scale}, x, 1e-6),
                tc.rmsnorm({"scale": t(scale)}, t(x), 1e-6)) < 1e-6
    assert _rel(jc.layernorm({"scale": scale, "bias": bias}, x),
                tc.layernorm({"scale": t(scale), "bias": t(bias)}, t(x))) \
        < 1e-6
    pos = np.arange(7, 12)
    assert _rel(jc.apply_rope(x, jnp.asarray(pos), 1e6),
                tc.apply_rope(t(x), t(pos), 1e6)) < 1e-5
    q, k, v = arr(2, 4, 40, 8), arr(2, 2, 70, 8), arr(2, 2, 70, 8)
    for kw in ({}, dict(q_chunk=16, kv_chunk=32)):
        assert _rel(jc.chunked_attention(q, k, v, **kw),
                    tc.chunked_attention(t(q), t(k), t(v), **kw)) < 1e-5
    kept = np.concatenate([np.arange(0, 20), np.arange(40, 70)])
    assert _rel(jc.chunked_attention(q, k[:, :, kept], v[:, :, kept],
                                     kv_positions=kept, kv_chunk=16),
                tc.chunked_attention(t(q), t(k[:, :, kept]),
                                     t(v[:, :, kept]), kv_positions=kept,
                                     kv_chunk=16)) < 1e-5
    for causal in (True, False):
        assert _rel(jc.full_attention(q, k, v, causal=causal),
                    tc.full_attention(t(q), t(k), t(v), causal=causal)) \
            < 1e-5
    keep = np.arange(70) % 3 != 1
    assert _rel(jc.decode_attention(q[:, :, :1], k, v, valid_len=50,
                                    keep_mask=jnp.asarray(keep)),
                tc.decode_attention(t(q[:, :, :1]), t(k), t(v),
                                    valid_len=50, keep_mask=t(keep))) < 1e-5
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), mlp="gelu")
    p = {"w_up": arr(16, 512), "w_down": arr(512, 16)}
    for spec in (None, _perfo(tt, "fini", 0.5)):
        jspec = None if spec is None else _perfo(jt, "fini", 0.5)
        assert _rel(jmlp.forward(p, cfg, x, "gelu", approx=jspec),
                    tmlp.forward({n: t(w) for n, w in p.items()}, cfg,
                                 t(x), "gelu", approx=spec)) < 1e-5
