"""The port's continuous-batching engine (`repro_torch.serving`) and serving
entry point (`repro_torch.launch.serve`) against the JAX package's, on the
same weights (`convert.lm_params`) and the request traces of
`tests/test_serving.py`, on the CPU.

Token streams are equal in float32. In bfloat16 (the smoke config's compute
type, which tests/test_serving.py serves) the two packages round each op in
other places, so a greedy step whose top two logits lie within bfloat16's
resolution can pick the other token: a stream is held equal up to its
first departure, and that departure must be such a near tie in the port's
own logits (within 0.02 of the largest logit, the decode-vs-forward
bound). The engine's counts are equal either way.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.types import parse_pragma as jax_pragma
from repro.launch import serve as jax_serve
from repro.models import build as jax_build
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.types import parse_pragma
from repro_torch.launch import serve
from repro_torch.launch import steps as steps_mod
from repro_torch.models import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.qos import set_decode_threshold
from repro_torch.serving import Request, ServingEngine

TAF50 = "memo(out:2:4:50.0) level(team)"


def _engines(taf=False, slots=3, cdt="bfloat16", max_len=48):
    """The JAX engine of tests/test_serving.py and the port's, on the same
    weights, plus a record of every port serve call: (its logits, the
    uid -> lane map of the live requests)."""
    cfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), remat=False,
                              compute_dtype=cdt)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               compute_dtype=cdt)
    if taf:
        cfg = dataclasses.replace(cfg, approx_decode=jax_pragma(TAF50))
        tcfg = dataclasses.replace(tcfg, approx_decode=parse_pragma(TAF50))
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    je = JaxEngine(model, params, slots=slots, max_len=max_len, prompt_len=8)
    te = ServingEngine(build(tcfg, device="cpu"),
                       convert.lm_params(params, tcfg, device="cpu"),
                       slots=slots, max_len=max_len, prompt_len=8)
    calls = []
    real = te._serve

    def recorded(params_, cache, tokens, pos):
        out = real(params_, cache, tokens, pos)
        calls.append((out[1].float().numpy().copy(),
                      {r.uid: i for i, r in enumerate(te.active) if r}))
        return out

    te._serve = recorded
    return cfg, je, te, calls


def _drain_trace(cfg, R):
    rng = np.random.RandomState(0)
    return [R(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
              .astype(np.int32), max_new_tokens=5 + i) for i in range(7)]


def _overlap_trace(cfg, R):
    rng = np.random.RandomState(1)
    long_req = [R(uid=0, prompt=rng.randint(0, cfg.vocab_size, 8)
                  .astype(np.int32), max_new_tokens=20)]
    return long_req + [R(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
                         .astype(np.int32), max_new_tokens=3)
                       for i in range(1, 5)]


def _taf_trace(cfg, R):
    rng = np.random.RandomState(2)
    return [R(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
              .astype(np.int32), max_new_tokens=12) for i in range(3)]


TRACES = {"drain": (_drain_trace, {}),
          "overlap": (_overlap_trace, dict(slots=2)),
          "taf": (_taf_trace, dict(taf=True)),
          # one slot: every admission after the first re-prefills and
          # resets the detector in both engines (the JAX engine's 1-slot
          # path), so the skip counts differ if the port spliced instead
          "one_slot": (_taf_trace, dict(taf=True, slots=1))}


def _stats(s):
    return (s.ticks, s.tokens_out, s.finished, s.taf_skipped, s.taf_total,
            s.canary_ticks, s.knob_moves, len(s.ttft_s), len(s.latency_s))


def _assert_streams(jreqs, treqs, calls, exact):
    for jr, tr in zip(jreqs, treqs):
        assert len(jr.output) == len(tr.output) == jr.max_new_tokens
        if exact or jr.output == tr.output:
            assert jr.output == tr.output, jr.uid
            continue
        k = next(i for i, (a, b) in enumerate(zip(jr.output, tr.output))
                 if a != b)
        logits, lanes = [c for c in calls if jr.uid in c[1]][k]
        row = logits[lanes[jr.uid]]
        gap = abs(row[jr.output[k]] - row[tr.output[k]])
        assert gap <= 0.02 * np.abs(row).max(), (jr.uid, k, gap)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_engine_streams_and_stats_match_jax(trace, cdt):
    make, kw = TRACES[trace]
    cfg, je, te, calls = _engines(cdt=cdt, **kw)
    jreqs, treqs = make(cfg, JaxRequest), make(cfg, Request)
    for r in jreqs:
        je.submit(r)
    for r in treqs:
        te.submit(r)
    js, ts = je.run_until_drained(), te.run_until_drained()
    assert _stats(ts) == _stats(js)
    _assert_streams(jreqs, treqs, calls, exact=cdt == "float32")
    if trace in ("taf", "one_slot"):
        assert ts.taf_skip_fraction > 0.0
    if trace == "overlap":   # no head-of-line blocking, as in the JAX test
        shorts = treqs[1:]
        assert min(s.finished_at for s in shorts) < treqs[0].finished_at


def test_admission_leaves_live_lanes_detector_and_knob_alone():
    """A request admitted into a running engine is spliced into its own
    lane: the other lanes' KV and memo rows, the batchless detector state
    and the actuated threshold keep their live values."""
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               compute_dtype="float32",
                               approx_decode=parse_pragma(TAF50))
    model = build(tcfg, device="cpu")
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                        slots=3, max_len=32, prompt_len=8)
    rng = np.random.RandomState(3)

    def req(uid, n):
        return Request(uid=uid, prompt=rng.randint(0, tcfg.vocab_size, 8)
                       .astype(np.int32), max_new_tokens=n)

    for uid in range(3):
        eng.submit(req(uid, 12 if uid else 2))
    for _ in range(3):
        eng.tick()
    assert eng.active[0] is None and eng.active[1] is not None
    set_decode_threshold(eng.cache, 0.25)
    before = {(g, n): t.clone() for g, leaves in eng.cache.items()
              for n, t in leaves.items()}
    eng.submit(req(9, 4))
    eng._admit()
    assert eng.active[0].uid == 9
    for (g, n), old in before.items():
        new = eng.cache[g][n]
        if n in ("threshold", "window", "filled", "remaining"):
            assert torch.equal(new, old), n
        else:
            assert torch.equal(new[:, 1:], old[:, 1:]), n      # lanes 1, 2
    assert float(eng.cache["taf"]["threshold"][0]) == 0.25


def test_engine_reads_the_device_once_a_tick_and_builds_nothing():
    """Per tick: one read of tokens (+ `remaining`), one in the TAF decode
    step; a knob move is a tensor write that reads nothing back and builds
    no step."""
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               compute_dtype="float32",
                               approx_decode=parse_pragma(TAF50))
    model = build(tcfg, device="cpu")
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                        slots=2, max_len=32, prompt_len=8)
    rng = np.random.RandomState(4)
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=rng.randint(
            0, tcfg.vocab_size, 8).astype(np.int32), max_new_tokens=10))
    eng.tick()
    assert eng.host_reads_per_tick == 2
    builds = steps_mod.builds()
    for value in (0.3, 0.0, 0.06, 0.06):
        reads = obs_metrics.host_reads()
        eng._apply_knob(value)
        assert obs_metrics.host_reads() == reads
        eng.tick()
        assert obs_metrics.host_reads() - reads == eng.host_reads_per_tick
    assert steps_mod.builds() == builds
    assert [m.value for m in eng.knob_events] == [0.3, 0.0, 0.06]


def test_sharding_raises_naming_what_it_needs():
    """Sharded serving without its process group, shards without a mesh,
    and per-shard knobs on an unsharded cache each raise, saying what is
    missing; nothing falls back to one process."""
    model = build(get_smoke_config("qwen3-1.7b"), device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        ServingEngine(model, {}, devices=2)
    with pytest.raises(ValueError, match="shards needs a mesh"):
        ServingEngine(model, {}, shards=2)
    cache = {"taf": {"threshold": torch.zeros(3),
                     "remaining": torch.zeros(3, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="shard_taf_state"):
        set_decode_threshold(cache, (0.1, 0.2))


def test_lint_raises_naming_its_item():
    model = build(get_smoke_config("qwen3-1.7b"), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        ServingEngine(model, {}, lint=True)


@pytest.mark.parametrize("taf", ["memo(out:2:4:50.0)", "memo(out:2:4:0.5)"])
def test_launch_serve_matches_jax_serve(taf):
    """`repro.launch.serve.main --smoke` (bfloat16) and the port's serve
    loop on its weights: the same tokens and TAF layer-step counts."""
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--gen", "8",
            "--prompt-len", "8", "--taf", taf]
    want = jax_serve.main(argv)
    params = jax_build(jax_smoke("qwen3-1.7b")).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              approx_decode=parse_pragma(taf))
    got = serve.run(cfg, batch=4, prompt_len=8, gen=8, device="cpu",
                    params=convert.lm_params(params, cfg, device="cpu"))
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["taf_total"] == 4 * 7 // 2 and got["taf_skipped"] > 0


def test_launch_serve_precise_matches_jax_steps_in_float32(capsys):
    """The precise serve loop against the JAX step functions' greedy loop
    (what `repro.launch.serve.main` runs) in float32; and the CLI."""
    from repro.launch import steps as jax_steps
    cfg = dataclasses.replace(jax_smoke("qwen3-1.7b"), remat=False,
                              compute_dtype="float32")
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    prefill = jax.jit(jax_steps.make_prefill_step(model, 16))
    step = jax.jit(jax_steps.make_serve_step(model))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for t in range(7):
        tok, _, cache = step(params, cache, tok, jnp.int32(8 + t))
        want.append(tok)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               compute_dtype="float32")
    got = serve.run(tcfg, batch=4, prompt_len=8, gen=8, device="cpu",
                    params=convert.lm_params(params, tcfg, device="cpu"))
    np.testing.assert_array_equal(got["tokens"],
                                  np.stack([np.asarray(w) for w in want], 1))
    toks = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--gen", "4",
                       "--prompt-len", "8", "--device", "cpu"])
    assert toks.shape == (4, 4)
    assert "tok/s" in capsys.readouterr().out


_PERFO = "perfo(fini:0.5)"


@pytest.mark.parametrize("arch,ffn", [("pixtral-12b", None),
                                      ("whisper-large-v3", None),
                                      ("olmoe-1b-7b", _PERFO)])
def test_launch_serve_zoo_matches_jax_steps_in_float32(arch, ffn, capsys):
    """`launch.serve` on the families the engine cannot serve (the vlm and
    audio ones, with their seeded frontend inputs) and on an MoE model
    under expert perforation, against the JAX step functions' greedy loop
    on the same inputs (float32). The vlm's decode positions follow its
    patch prefix (the JAX entry point's count from the prompt alone would
    overwrite the prompt's last K/V)."""
    from repro.launch import steps as jax_steps
    cfg = dataclasses.replace(jax_smoke(arch), remat=False,
                              compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    if ffn:
        cfg = dataclasses.replace(cfg, approx_ffn=jax_pragma(ffn))
        tcfg = dataclasses.replace(tcfg, approx_ffn=parse_pragma(ffn))
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    inputs, prefix = serve.frontend_batch(tcfg, 4, 8, 0)
    assert prefix == (cfg.n_patch_tokens if arch == "pixtral-12b" else 0)
    assert set(inputs) == {"tokens"} | (
        {"patch_embeds"} if arch == "pixtral-12b" else
        {"frames"} if arch == "whisper-large-v3" else set())
    prefill = jax.jit(jax_steps.make_prefill_step(model, prefix + 16))
    step = jax.jit(jax_steps.make_serve_step(model))
    logits, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in inputs.items()})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    for t in range(7):
        tok, _, cache = step(params, cache, tok, jnp.int32(prefix + 8 + t))
        want.append(tok)
    got = serve.run(tcfg, batch=4, prompt_len=8, gen=8, device="cpu",
                    params=convert.lm_params(params, tcfg, device="cpu"))
    np.testing.assert_array_equal(got["tokens"],
                                  np.stack([np.asarray(w) for w in want], 1))
    argv = ["--arch", arch, "--smoke", "--gen", "3", "--prompt-len", "8",
            "--device", "cpu"] + (["--approx-ffn", ffn] if ffn else [])
    assert serve.main(argv).shape == (4, 3)
    assert "tok/s" in capsys.readouterr().out


def test_engine_refuses_frontend_families_and_qos_without_decode_taf():
    """The engine prefills tokens only, so it refuses the vlm and audio
    families, naming their inputs and `launch.serve`; QoS needs decode
    TAF, which a TAF spec on an MoE or MLA model does not run."""
    for arch, key in (("pixtral-12b", "patch_embeds"),
                      ("whisper-large-v3", "frames")):
        model = build(get_smoke_config(arch), device="cpu")
        with pytest.raises(ValueError, match=f"{key}.*launch.serve"):
            ServingEngine(model, {})
    from repro_torch import qos
    taf = parse_pragma(TAF50)
    for arch in ("olmoe-1b-7b", "deepseek-v3-671b"):
        cfg = dataclasses.replace(get_smoke_config(arch), approx_decode=taf)
        q = qos.QosEngine(qos.QosPolicy.from_records([], metric="mcr"),
                          0.1)
        with pytest.raises(ValueError, match="without MLA or MoE"):
            ServingEngine(build(cfg, device="cpu"), {}, qos=q)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b",
                                  "whisper-large-v3"])
def test_sharded_step_walks_every_cache(arch):
    """The sharded serve step over 2 shards of 2 lanes on the hybrid's
    (G, M, B, ...) mixer caches, tail and shared-attention caches, the
    ssm's group-less state and the audio model's memory equals the
    unsharded step lane for lane (float32, 1e-5), caches included."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    inputs, _ = serve.frontend_batch(cfg, 4, 8, 0)
    (l1, c1), (_, c2) = (model.prefill(params, dict(inputs, max_len=16))
                         for _ in range(2))
    step = steps_mod.make_serve_step(model)
    sharded = steps_mod.make_sharded_serve_step(
        model, {"data": 1, "model": 1}, 2, 4)
    tok = torch.argmax(l1, -1).to(torch.int32)
    for t in range(3):
        nxt, la, c1 = step(params, c1, tok, 8 + t)
        _, lb, c2 = sharded(params, c2, tok, 8 + t)
        tok = nxt
        np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for (_, a), (_, b) in zip(_cache_leaves(c1), _cache_leaves(c2)):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=1e-5, atol=1e-5)


def _cache_leaves(cache, path=()):
    if isinstance(cache, dict):
        for k in sorted(cache):
            yield from _cache_leaves(cache[k], path + (k,))
    elif cache is not None:
        yield path, cache


def test_serving_examples_run_on_the_cpu(tmp_path, capsys):
    """`repro_torch.examples.continuous_batching` and `approx_serving` (the
    ports of examples/*.py) drain their traces on the CPU."""
    from repro_torch.examples import approx_serving, continuous_batching
    stats = continuous_batching.main(["--device", "cpu"])
    assert stats.finished == 10 and stats.taf_skip_fraction > 0
    eng, q = approx_serving.main(["--device", "cpu", "--db",
                                  str(tmp_path / "db.json")])
    assert eng.stats.finished == 14 and eng.knob_events
    assert q.summary()["classes"]["default"]["exposed_mean_error"] < 0.01
    out = capsys.readouterr().out
    assert "served 10/10 requests" in out and "ladder (" in out
