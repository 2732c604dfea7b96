"""The port's sharding rules, elastic mesh choice, straggler monitor and
int8 quantizer against the JAX package's on the same inputs.

The JAX specs come from a subprocess with 8 fake host devices (the device
count must be set before jax initializes, as in tests/test_distributed.py):
`param_shardings`, `opt_state_shardings` and `cache_shardings` over
`jax.eval_shape` of each smoke model's init on a (2, 4) mesh. The port
builds its trees from the same shapes in its own layout (one dict per
layer in a list, so a JAX spec's layer-stack entries drop), from meta
tensors, and holds each model's own `init` / `init_cache` trees to that
layout.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import qos as tqos
from repro_torch.configs import get_smoke_config
from repro_torch.models import build as tbuild
from repro_torch.models.lm import shard_taf_state
from repro_torch.optim import compress
from repro_torch.runtime import elastic, sharding, straggler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-1.7b", "deepseek-7b", "olmoe-1b-7b", "rwkv6-1.6b",
         "zamba2-7b", "starcoder2-3b", "qwen1.5-4b", "pixtral-12b",
         "deepseek-v3-671b", "whisper-large-v3")
MESH = {"data": 2, "model": 4}
BATCHES = (1, 6, 8)


# number of layer-stack axes each JAX subtree leads with (longest prefix)
_TRANSFORMER = {("dense_blocks",): 1, ("moe_blocks",): 1}
STACKS = {
    "qwen3-1.7b": _TRANSFORMER, "deepseek-7b": _TRANSFORMER,
    "olmoe-1b-7b": _TRANSFORMER, "starcoder2-3b": _TRANSFORMER,
    "qwen1.5-4b": _TRANSFORMER, "pixtral-12b": _TRANSFORMER,
    "deepseek-v3-671b": _TRANSFORMER,
    "rwkv6-1.6b": {("layers",): 1},
    "zamba2-7b": {("layers", "main"): 2, ("layers", "tail"): 1},
    "whisper-large-v3": {("enc_blocks",): 1, ("dec_blocks",): 1},
}


_JAX_SPECS = r"""
import json, jax
from repro.configs import get_smoke_config
from repro.models import build
from repro.optim import adamw
from repro import qos
from repro.compat import make_mesh
from repro.runtime import sharding as sh

mesh = make_mesh((2, 4), ("data", "model"))

def key(p):
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return getattr(p, attr)
    raise TypeError(p)

def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def rows(tree, shardings):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(shardings)
    return [[[key(p) for p in path], list(leaf.shape), spec_json(s.spec)]
            for (path, leaf), s in zip(leaves, specs)]

out = {}
for arch in %(archs)r:
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(adamw.init, params)
    caches = {b: jax.eval_shape(lambda: model.init_cache(b, 40))
              for b in %(batches)r}
    out[arch] = {
        "decode": {b: [[[key(p) for p in path], spec_json(s)]
                       for (path, _), s in zip(
                           jax.tree_util.tree_flatten_with_path(c)[0],
                           jax.tree_util.tree_leaves(
                               sh.decode_partition_specs(mesh, c, b),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec)))]
                   for b, c in caches.items()},
        "params": rows(params, sh.param_shardings(mesh, params)),
        "params_fsdp": rows(params, sh.param_shardings(mesh, params,
                                                       fsdp=True)),
        "opt": rows(opt, sh.opt_state_shardings(mesh, opt)),
        "opt_fsdp": rows(opt, sh.opt_state_shardings(mesh, opt, fsdp=True)),
        "cache": {b: rows(c, sh.cache_shardings(mesh, c, b))
                  for b, c in caches.items()},
    }
model = build(qos.default_decode_cfg())
taf = {}
for b in %(batches)r:
    cache = jax.eval_shape(lambda: model.init_cache(b, 40))
    leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
    taf[b] = {
        "specs": rows(cache, sh.cache_shardings(mesh, cache, b)),
        "kinds": [[[key(p) for p in path],
                   sh.decode_shard_axis(path, leaf.shape, b)]
                  for path, leaf in leaves],
    }
from repro.models.lm import shard_taf_state
cache = jax.eval_shape(lambda: shard_taf_state(model.init_cache(6, 40), 4))
specs = sh.decode_partition_specs(mesh, cache, 6)
taf["decode"] = [[[key(p) for p in path], spec_json(s)]
                 for (path, _), s in zip(
                     jax.tree_util.tree_flatten_with_path(cache)[0],
                     jax.tree_util.tree_leaves(
                         specs, is_leaf=lambda x: isinstance(
                             x, jax.sharding.PartitionSpec)))]
out["taf_cache"] = taf
print("SPECS " + json.dumps(out))
""" % {"archs": ARCHS, "batches": BATCHES}


@pytest.fixture(scope="module")
def jax_specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_SPECS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("SPECS ")][-1]
    doc = json.loads(line[len("SPECS "):])
    doc["taf_cache"] = {(int(k) if k.isdigit() else k): v
                        for k, v in doc["taf_cache"].items()}
    for arch in ARCHS:
        for part in ("cache", "decode"):
            doc[arch][part] = {int(k): v
                               for k, v in doc[arch][part].items()}
    return doc


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _stack_depth(arch, keys):
    best, depth = 0, 0
    for prefix, n in STACKS[arch].items():
        if tuple(keys[:len(prefix)]) == prefix and len(prefix) > best:
            best, depth = len(prefix), n
    return best, depth


def _port_tree(arch, rows, skip=0):
    """The port-layout tree of the JAX leaves `rows` (meta tensors): a
    subtree stacked on k axes becomes k nested lists of per-layer dicts.
    `skip` leading keys (an optimizer state's field name) pass through.
    Returns the tree and, per JAX leaf, its port paths with its JAX spec
    minus the stack entries."""
    tree, expect = {}, []
    for keys, shape, spec in rows:
        head, rest = keys[:skip], keys[skip:]
        plen, depth = _stack_depth(arch, rest)
        stack = shape[:depth]
        node = tree
        for k in head + rest[:plen]:
            node = node.setdefault(k, {})
        if depth:
            # the prefix's dict becomes nested lists of per-layer dicts
            parent = tree
            for k in (head + rest[:plen])[:-1]:
                parent = parent[k]
            last = (head + rest[:plen])[-1]
            if not isinstance(parent[last], list):
                def grid(dims):
                    return ([grid(dims[1:]) for _ in range(dims[0])]
                            if dims else {})
                parent[last] = grid(list(stack))
        for index in np.ndindex(*stack):
            node = tree
            for k in head + rest[:plen]:
                node = node[k]
            for i in index:
                node = node[i]
            for k in rest[plen:-1]:
                node = node.setdefault(k, {})
            node[rest[-1]] = torch.empty(shape[depth:], device="meta")
            expect.append((tuple(head + rest[:plen]) + index
                           + tuple(rest[plen:]), _spec(spec)[depth:]))
    return tree, expect


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_jax(jax_specs, arch, fsdp):
    rows = jax_specs[arch]["params_fsdp" if fsdp else "params"]
    tree, expect = _port_tree(arch, rows)
    got = sharding.param_specs(MESH, tree, fsdp=fsdp)
    assert len(expect) >= len(rows)
    for path, want in expect:
        assert _at(got, path) == want, (path, _at(got, path), want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fsdp", [False, True])
def test_opt_state_specs_equal_jax(jax_specs, arch, fsdp):
    rows = jax_specs[arch]["opt_fsdp" if fsdp else "opt"]
    step = [r for r in rows if len(r[0]) == 1]
    moments = [r for r in rows if len(r[0]) > 1]
    tree, expect = _port_tree(arch, moments, skip=1)
    for keys, shape, spec in step:
        tree[keys[0]] = torch.empty(shape, device="meta")
        expect.append((tuple(keys), _spec(spec)))
    got = sharding.opt_state_specs(MESH, tree, fsdp=fsdp)
    assert step and _at(got, tuple(step[0][0])) == ()
    for path, want in expect:
        assert _at(got, path) == want, (path, _at(got, path), want)


@pytest.mark.parametrize("fsdp", [False, True])
def test_opt_state_specs_of_an_adamw_state_mirror_the_masters(fsdp):
    """The optimizer state the train steps take (`adamw.AdamWState`, a named
    tuple) is mapped field by field: each moment leaf's spec is its
    master's (the embedding's vocab split too: a tuple taken for a layer
    stack replicated it on every device), the step counter replicated."""
    from repro_torch.launch import specs as specs_mod
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), fsdp=fsdp)
    masters = specs_mod.meta_model(tbuild(cfg, device="cpu")).masters(
        specs_mod.MetaDraw())
    got = sharding.opt_state_specs(MESH, adamw.init(masters), fsdp=fsdp)
    want = sharding.param_specs(MESH, masters, fsdp=fsdp)
    assert isinstance(got, adamw.AdamWState) and got.step == ()
    assert got.m == want and got.v == want
    assert want["embed"][0] == "model"


def _cache_tree(rows):
    tree = {}
    for keys, shape, _ in rows:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(shape, device="meta")
    return tree


def _compare_cache(rows, batch, axes):
    """Port cache specs against JAX's wherever JAX's batch-dim heuristic
    (the first dim equal to the batch) picks the leaf's true batch axis;
    returns the number of leaves compared."""
    got = sharding.cache_specs(MESH, _cache_tree(rows), batch,
                               batch_axes=axes)
    n = 0
    for keys, shape, spec in rows:
        first = next((i for i, s in enumerate(shape) if s == batch), None)
        if first != axes[tuple(keys)]:
            continue        # the heuristic is ambiguous for this leaf
        assert _at(got, keys) == _spec(spec), (keys, batch)
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(jax_specs, arch):
    from repro_torch.models.lm import CACHE_BATCH_AXES
    compared = sum(_compare_cache(jax_specs[arch]["cache"][b], b,
                                  CACHE_BATCH_AXES)
                   for b in BATCHES)
    # batch 6 and 8 are unambiguous for every leaf of these caches
    assert compared >= 2 * len(jax_specs[arch]["cache"][6])


@pytest.mark.parametrize("arch", ARCHS)
def test_port_trees_have_the_jax_layout(jax_specs, arch):
    """The port model's own parameter tree (`init`) is the JAX tree in the
    port's layout (`_port_tree`: the same leaves and shapes), and its
    decode cache has the JAX cache's leaves, at the same paths and of the
    same shapes, at every batch size."""
    model = tbuild(get_smoke_config(arch), device="cpu")
    assert model.STACKS == STACKS[arch]     # what convert.lm_params reads
    params = model.init(torch.Generator().manual_seed(0))
    want, _ = _port_tree(arch, jax_specs[arch]["params"])

    def shapes(tree, path=()):
        if isinstance(tree, dict):
            return {k: shapes(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return None if tree is None else tuple(tree.shape)

    assert shapes(params) == shapes(want)
    for b in BATCHES:
        cache = shapes(model.init_cache(b, 40))
        cache = {k: v for k, v in cache.items() if v is not None}
        assert cache == shapes(_cache_tree(jax_specs[arch]["cache"][b]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_partition_specs_equal_jax(jax_specs, arch):
    """The sharded serve step's cache specs on each family's cache, leaf
    for leaf against JAX's wherever its batch-dim heuristic picks the
    leaf's true batch axis (batch 6 and 8: every leaf)."""
    from repro_torch.models.lm import CACHE_BATCH_AXES
    model = tbuild(get_smoke_config(arch), device="cpu")
    for b in (6, 8):
        got = sharding.decode_partition_specs(MESH, model.init_cache(b, 40),
                                              b)
        rows = jax_specs[arch]["decode"][b]
        assert rows
        for keys, spec in rows:
            want = _spec(spec)
            want += (None,) * (len(_at(got, keys)) - len(want))
            assert _at(got, keys) == want, (keys, b)
            assert CACHE_BATCH_AXES[tuple(keys)] is not None


def test_taf_cache_specs_and_decode_axes_equal_jax(jax_specs):
    from repro_torch.models.lm import CACHE_BATCH_AXES
    taf = jax_specs["taf_cache"]
    for b in BATCHES:
        assert _compare_cache(taf[b]["specs"], b, CACHE_BATCH_AXES) > 0
    # decode_shard_axis at batch 6, where JAX's heuristic is unambiguous
    for keys, kind in taf[6]["kinds"]:
        want = tuple(kind) if kind is not None else None
        assert sharding.decode_shard_axis(tuple(keys)) == want, keys
    # the sharded step's cache specs on a shard_taf_state cache
    cfg = tqos.default_decode_cfg()
    cache = shard_taf_state(tbuild(cfg, device="cpu").init_cache(6, 40),
                            4)
    got = sharding.decode_partition_specs(MESH, cache, 6)
    assert len(taf["decode"]) == sum(len(g) for g in cache.values())
    for keys, spec in taf["decode"]:
        assert _at(got, keys) == _spec(spec), keys


def test_decode_shard_axis_checks_the_batch_extent():
    assert sharding.decode_shard_axis(("dense", "k"), (2, 6, 2, 40, 32),
                                      6) == ("batch", 1)
    with pytest.raises(ValueError, match="batch dim 6, expected 4"):
        sharding.decode_shard_axis(("dense", "k"), (2, 6, 2, 40, 32), 4)


def test_best_mesh_shape_and_accum_steps_equal_jax():
    from repro.runtime import elastic as jel
    for n in range(1, 65):
        for mp in (1, 2, 3, 4, 8, 16):
            for mn in (1, 2):
                assert elastic.best_mesh_shape(n, mp, mn) == \
                    jel.best_mesh_shape(n, mp, mn)
    for gb in (8, 12, 16, 30, 64):
        for pdb in (1, 2, 4):
            for nd in (1, 2, 3, 4, 8):
                try:
                    want = jel.accum_steps_for(gb, pdb, nd)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        elastic.accum_steps_for(gb, pdb, nd)
                    continue
                assert elastic.accum_steps_for(gb, pdb, nd) == want


def test_meshes_need_a_process_group_of_their_size():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 8"):
        mesh.make_debug_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="nproc-per-node 256"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="nproc-per-node 512"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")


def test_step_monitor_events_equal_jax():
    from repro.runtime import straggler as jst
    rng = np.random.RandomState(0)
    durations = np.abs(rng.normal(1.0, 0.1, 200))
    durations[rng.choice(200, 12, replace=False)] *= rng.uniform(2, 6, 12)
    mons = [straggler.StepMonitor(window=16, threshold=2.5, warmup_steps=4),
            jst.StepMonitor(window=16, threshold=2.5, warmup_steps=4)]
    for i, d in enumerate(durations):
        evs = [m.record(float(d), host=i % 3) for m in mons]
        assert (evs[0] is None) == (evs[1] is None)
        if i % 20 == 0:
            hosts = {h: float(rng.uniform(0.5, 4.0)) for h in range(5)}
            assert [dataclasses.astuple(e) for e in
                    mons[0].record_host_durations(hosts)] == \
                [dataclasses.astuple(e) for e in
                 mons[1].record_host_durations(hosts)]
    assert len(mons[0].events) > 0
    assert [dataclasses.astuple(e) for e in mons[0].events] == \
        [dataclasses.astuple(e) for e in mons[1].events]
    guard = straggler.PreemptionGuard(install=False)
    assert not guard.should_stop
    guard.trigger()
    assert guard.should_stop


@pytest.mark.parametrize("case", ["normal", "ties", "bf16", "zeros"])
def test_quantize_tensor_equals_jax_bit_for_bit(case):
    import jax.numpy as jnp
    from repro.optim import compress as jcomp
    rng = np.random.RandomState(1)
    if case == "ties":
        # max 127 makes the scale exactly 1.0: every x.5 is a rounding tie
        g = np.concatenate([np.arange(-127, 128) + 0.5, [127.0, -3.5]])
        g = np.clip(g, -127, 127).astype(np.float32)
    elif case == "zeros":
        g = np.zeros((7, 5), np.float32)
    else:
        g = (rng.standard_normal((33, 65)) * 3).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if case == "bf16" else jnp.float32)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(
        torch.bfloat16 if case == "bf16" else torch.float32)
    jq, js = jcomp.quantize_tensor(jg)
    tq, ts = compress.quantize_tensor(tg)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()).tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        compress.dequantize_tensor(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_tensor(jq, js)))


def test_compress_grads_error_feedback_equals_jax():
    import jax.numpy as jnp
    from repro.optim import compress as jcomp
    rng = np.random.RandomState(2)
    grads = [{"w": rng.standard_normal((8, 4)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
             for _ in range(3)]
    jef = jcomp.init_ef({k: jnp.asarray(v) for k, v in grads[0].items()})
    tef = compress.init_ef({k: torch.from_numpy(v)
                            for k, v in grads[0].items()})
    for g in grads:
        jq, jh, jef = jcomp.compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        tq, th, tef = compress.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tef)
        for k in g:
            np.testing.assert_array_equal(tq[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))
