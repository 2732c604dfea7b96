"""The sharded step's layouts on 8 gloo ranks of the CPU (a 2 data x 4 model
mesh), each held to the plain one-process computation on the same numpy
inputs, at smoke widths in float32:

* the loss's vocab-parallel cross-entropy (`models.lm._chunk_nll` through
  `common.logsumexp_pick`): loss and the gradients of the hidden states
  and the head equal the plain ones within 1e-6, with the vocab split
  evenly (256 over 4) and unevenly (250), and no collective moves a tensor
  with the vocab's extent (the logits are never made whole);
* MoE `forward` on DTensors (`moe._dispatch_by_shard`): output, aux loss
  and the input's gradient equal the plain version's within 1e-6, the
  weights' gradients (sums over the batch, which the data ranks split)
  within 1e-6 of their largest element, and the dispatch buffer's local
  shard is 1/(data x model) of the whole;
* a Mamba2 mixer on DTensors (`mamba2._sharded_conv`, the input
  projection split over the model ranks across its pieces' boundaries):
  output, prefill state and gradients equal the plain version's within
  1e-5, the state laid out as the cache holds it, and no collective moves
  a tensor of the projection's width or gathers an activation over the
  model ranks;
* the prefill of every family with its cache made on the mesh
  (`launch.steps.make_prefill_step(..., mesh)`): each cache leaf laid out
  by `runtime.sharding.cache_specs`, its values and the last logits equal
  the plain prefill's, a prompt shorter than the cache included (the
  sequence-split cache of KV heads that do not divide the model ranks);
  then one decode step on each cache: the position written into its
  shard (`common.write_rows`), cache and logits equal the plain step's
  (whisper's with its encoder frames split over the model ranks);
* attention whose heads the model ranks do not divide (`split_heads`,
  `chunked_attention`, `merge_dims` on DTensors): padded heads and GQA
  with KV heads the ranks do not divide, outputs and gradients equal the
  plain ones within 1e-5, no collective gathering over the model ranks
  or moving every head; whisper's cross-attention over split frames.

The ranks run in subprocesses (`test_torch_distributed.run_ranks`).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import run_ranks  # noqa: E402

_LAYOUTS = r"""
import dataclasses
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, steps
from repro_torch.launch import specs as specs_mod
from repro_torch.models import build, common, lm, moe
from repro_torch.optim import adamw
from repro_torch.runtime import elastic, sharding
torch.manual_seed(0)
mesh = elastic.make_mesh((2, 4), ('data', 'model'), device='cpu')
out = {}

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

def err(a, b):
    return float((full(a).double() - b.double()).abs().max())

def place(t, places):
    return DTensor.from_local(t, mesh, [Replicate(), Replicate()],
                              run_check=False).redistribute(mesh, places)

# `t` laid out by `places`, its local shard the autograd leaf: `.dtensor()`
# wraps it (inside the counted region), `.grad` is the gradient as a
# DTensor. torch 2.11 gathers an unevenly split DTensor leaf's gradient
# whole as it accumulates it, which no model's leaf (a parameter, split
# evenly) does
class Leaf:

    def __init__(self, t, places):
        d = place(t, places)
        self.spec = (d.placements, d.shape, d.stride())
        self.local = d.to_local().clone().requires_grad_()

    def _wrap(self, local):
        places, shape, stride = self.spec
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=shape, stride=stride)

    def dtensor(self):
        return self._wrap(self.local)

    @property
    def grad(self):
        return self._wrap(self.local.grad)

# -- the vocab-parallel loss --------------------------------------------
for v in (256, 250):
    rng = np.random.RandomState(v)
    h0 = torch.tensor(rng.standard_normal((4, 8, 64)), dtype=torch.float32)
    w0 = torch.tensor(rng.standard_normal((64, v)) * 0.3,
                      dtype=torch.float32)
    lb = torch.tensor(rng.randint(0, v, (4, 8)))
    mask = torch.tensor(rng.rand(4, 8) > 0.2, dtype=torch.float32)
    h1, w1 = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    plain = lm._chunk_nll(h1, w1, lb, mask)
    plain.backward()
    h2 = place(h0, [Shard(0), Replicate()]).requires_grad_()
    w2 = Leaf(w0, [Replicate(), Shard(1)])
    count = dryrun.DeviceCount({info["group"]: name for name, info in
                                dryrun.mesh_axes(mesh).items()})
    with implicit_replication(), count:
        loss = lm._chunk_nll(h2, w2.dtensor(),
                             place(lb, [Shard(0), Replicate()]),
                             place(mask, [Shard(0), Replicate()]))
        loss.backward()
    out[f"loss_{v}"] = [abs(float(full(loss)) - float(plain)),
                        err(h2.grad, h1.grad), err(w2.grad, w1.grad),
                        float(plain)]
    rows = count.by_shape()
    out[f"loss_{v}_whole_vocab"] = [r for r in rows if v in r["shape"]]
    out[f"loss_{v}_logit_collectives"] = [
        r for r in rows if r["shape"] == [2, 8]]

# -- MoE dispatch and combine -------------------------------------------
cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                          compute_dtype="float32")
model = build(cfg, device="cpu")
p0 = model.init(torch.Generator().manual_seed(0))["moe_blocks"][0]["moe"]
x0 = torch.tensor(np.random.RandomState(1).standard_normal((4, 32, 64)),
                  dtype=torch.float32)
r0 = torch.tensor(np.random.RandomState(2).standard_normal((4, 32, 64)),
                  dtype=torch.float32)
p1 = {k: v.clone().requires_grad_() for k, v in p0.items()}
x1 = x0.clone().requires_grad_()
y1, a1 = moe.forward(p1, cfg, x1)
((y1 * r0).sum() + a1).backward()
specs = sharding.param_specs(mesh, {"moe_blocks": [{"moe": p0}]})
p2 = {k: v.requires_grad_() for k, v in sharding.place(
    {"moe_blocks": [{"moe": p0}]}, mesh, specs)["moe_blocks"][0]["moe"]
    .items()}
x2 = place(x0, [Shard(0), Replicate()]).requires_grad_()
seen = []
dispatch = moe._dispatch_by_shard

def spy(*a, **k):
    xe, combine = dispatch(*a, **k)
    seen.append((tuple(xe.shape), tuple(xe.to_local().shape),
                 [[type(p).__name__, getattr(p, "dim", None)]
                  for p in xe.placements]))
    return xe, combine

moe._dispatch_by_shard = spy
with implicit_replication():
    y2, a2 = moe.forward(p2, cfg, x2)
    ((y2 * place(r0, [Shard(0), Replicate()])).sum() + a2).backward()
out["moe"] = [err(y2, y1), abs(float(full(a2)) - float(a1)),
              err(x2.grad, x1.grad),
              max(err(p2[k].grad, p1[k].grad)
                  / max(1.0, float(p1[k].grad.abs().max())) for k in p1),
              float(y1.abs().max())]
out["moe_xe"] = seen
moe._dispatch_by_shard = dispatch

# -- a Mamba2 mixer: its projection taken apart by columns --------------
from repro_torch.models import mamba2
cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                          compute_dtype="float32")
model = build(cfg, device="cpu")
p0 = model.init(torch.Generator().manual_seed(0))["layers"]["main"][0][0][
    "mixer"]
x0 = torch.tensor(np.random.RandomState(4).standard_normal((4, 16, 64)),
                  dtype=torch.float32)
r0 = torch.tensor(np.random.RandomState(5).standard_normal((4, 16, 64)),
                  dtype=torch.float32)
p1 = adamw.tree_map(lambda t: t.clone().requires_grad_(), p0)
x1 = x0.clone().requires_grad_()
y1, st1 = mamba2.forward(p1, cfg, x1, return_state=True)
(y1 * r0).sum().backward()
tree = {"mixer": p0}
p2 = adamw.tree_map(lambda t: t.requires_grad_(), sharding.place(
    tree, mesh, sharding.param_specs(mesh, tree))["mixer"])
x2 = place(x0, [Shard(0), Replicate()]).requires_grad_()
count = dryrun.DeviceCount({info["group"]: name for name, info in
                            dryrun.mesh_axes(mesh).items()})
with implicit_replication(), count:
    y2, st2 = mamba2.forward(p2, cfg, x2, return_state=True)
    (y2 * place(r0, [Shard(0), Replicate()])).sum().backward()
grads = [(a.grad, b.grad) for a, b in zip(adamw.leaves(p2),
                                          adamw.leaves(p1))]
out["mamba2"] = [err(y2, y1), err(st2["conv"], st1["conv"]),
                 err(st2["ssm"], st1["ssm"]), err(x2.grad, x1.grad),
                 max(err(a, b) / max(1.0, float(b.abs().max()))
                     for a, b in grads),
                 float(y1.abs().max()),
                 p2["w_in"].shape[-1], p2["w_in"].to_local().shape[-1]]
out["mamba2_state_places"] = [
    [[type(p).__name__, getattr(p, "dim", None)] for p in st2[k].placements]
    for k in ("conv", "ssm")]
out["mamba2_collectives"] = count.by_shape()

# -- attention whose heads the model ranks do not divide ----------------
from repro_torch.models import attention, whisper

def counted():
    return dryrun.DeviceCount({info["group"]: name for name, info in
                               dryrun.mesh_axes(mesh).items()})

def relerr(pairs):
    return max(err(a, b) / max(1.0, float(b.abs().max())) for a, b in pairs)

for name, heads, kv in (("padded", 6, 6), ("gqa", 6, 2)):
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), n_heads=heads,
                              n_kv_heads=kv, head_dim=16,
                              compute_dtype="float32")
    p0 = attention.init_params(torch.Generator().manual_seed(0), cfg,
                               lambda n, t: t)
    rng = np.random.RandomState(6)
    x0, r0 = (torch.tensor(rng.standard_normal((4, 24, 64)),
                           dtype=torch.float32) for _ in range(2))
    pos = torch.arange(24)
    p1 = adamw.tree_map(lambda t: t.clone().requires_grad_(), p0)
    x1 = x0.clone().requires_grad_()
    y1 = attention.forward(p1, cfg, x1, pos)
    (y1 * r0).sum().backward()
    tree = {"attn": p0}
    p2 = adamw.tree_map(lambda t: t.requires_grad_(), sharding.place(
        tree, mesh, sharding.param_specs(mesh, tree))["attn"])
    x2 = place(x0, [Shard(0), Replicate()]).requires_grad_()
    count = counted()
    with implicit_replication(), count:
        y2 = attention.forward(p2, cfg, x2, pos)
        (y2 * place(r0, [Shard(0), Replicate()])).sum().backward()
    out["attn_" + name] = [
        err(y2, y1), err(x2.grad, x1.grad),
        relerr([(a.grad, b.grad) for a, b in zip(adamw.leaves(p2),
                                                 adamw.leaves(p1))]),
        float(y1.abs().max())]
    out["attn_" + name + "_collectives"] = count.by_shape()
    # chunked_attention itself on q, k, v split over the model ranks by
    # heads as `split_heads` splits them (6 over 4: 2, 2, 2, 0; 2 KV heads:
    # 1, 1, 0, 0)
    q0, k0, v0 = (torch.tensor(rng.standard_normal((4, h, 24, 16)),
                               dtype=torch.float32)
                  for h in (heads, kv, kv))
    g0 = torch.tensor(rng.standard_normal((4, heads, 24, 16)),
                      dtype=torch.float32)
    plain = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    o1 = common.chunked_attention(*plain, q_chunk=8, kv_chunk=8)
    (o1 * g0).sum().backward()
    split = [Leaf(t, [Shard(0), Shard(1)]) for t in (q0, k0, v0)]
    count = counted()
    with implicit_replication(), count:
        o2 = common.chunked_attention(*[t.dtensor() for t in split],
                                      q_chunk=8, kv_chunk=8)
        (o2 * place(g0, [Shard(0), Shard(1)])).sum().backward()
    out["chunked_" + name] = [
        err(o2, o1), max(err(a.grad, b.grad) for a, b in zip(split, plain)),
        float(o1.abs().max()),
        [[type(p).__name__, getattr(p, "dim", None)] for p in o2.placements]]
    out["chunked_" + name + "_collectives"] = count.by_shape()

# -- whisper's cross-attention over encoder frames split over `model` ---
cfg = dataclasses.replace(get_smoke_config("whisper-large-v3"),
                          compute_dtype="float32")
p0 = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))[
    "dec_blocks"][0]["cross_attn"]
rng = np.random.RandomState(8)
x0, r0 = (torch.tensor(rng.standard_normal((4, 4, 64)), dtype=torch.float32)
          for _ in range(2))
m0 = torch.tensor(rng.standard_normal((4, 16, 64)), dtype=torch.float32)
p1 = adamw.tree_map(lambda t: t.clone().requires_grad_(), p0)
x1, m1 = x0.clone().requires_grad_(), m0.clone().requires_grad_()
y1 = whisper._cross_attention(p1, cfg, x1, m1)
(y1 * r0).sum().backward()
tree = {"cross_attn": p0}
p2 = adamw.tree_map(lambda t: t.requires_grad_(), sharding.place(
    tree, mesh, sharding.param_specs(mesh, tree))["cross_attn"])
x2 = place(x0, [Shard(0), Replicate()]).requires_grad_()
m2 = place(m0, [Shard(0), Shard(1)]).requires_grad_()
with implicit_replication():
    y2 = whisper._cross_attention(p2, cfg, x2, m2)
    (y2 * place(r0, [Shard(0), Replicate()])).sum().backward()
out["cross"] = [err(y2, y1), err(x2.grad, x1.grad), err(m2.grad, m1.grad),
                relerr([(a.grad, b.grad) for a, b in zip(
                    adamw.leaves(p2), adamw.leaves(p1))]),
                float(y1.abs().max())]

# -- prefill with the cache made on the mesh ----------------------------
for arch in ("qwen3-1.7b", "deepseek-7b", "olmoe-1b-7b", "deepseek-v3-671b",
             "zamba2-7b", "whisper-large-v3", "rwkv6-1.6b"):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    model = build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    shape = ShapeConfig("p", 12, 4, "prefill")
    rng = np.random.RandomState(3)
    batch = {k: torch.as_tensor(
        rng.standard_normal(tuple(s.shape)) if s.is_floating_point()
        else rng.randint(0, cfg.vocab_size, tuple(s.shape))).to(
            torch.float32 if s.is_floating_point() else s.dtype)
        for k, s in specs_mod.prefill_batch_specs(cfg, shape).items()}
    max_len = 16
    want_logits, want = steps.make_prefill_step(model, max_len)(params,
                                                                batch)
    pp = sharding.place(params, mesh, sharding.param_specs(mesh, params))
    pb = sharding.place(batch, mesh, specs_mod.batch_shardings(mesh, batch))
    with implicit_replication():
        logits, cache = steps.make_prefill_step(model, max_len, mesh)(pp,
                                                                      pb)
    cspecs = sharding.cache_specs(mesh, want, 4)
    if arch == "whisper-large-v3":
        out["whisper_memory"] = [[type(p).__name__, getattr(p, "dim", None)]
                                 for p in cache["memory"].placements]
    leaves, laid_out, split = [], True, 0
    def walk(a, b, s):
        global laid_out, split
        if a is None:
            return
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], s[k])
            return
        leaves.append(err(a, b))
        laid_out &= (isinstance(a, DTensor) and list(a.placements)
                     == list(sharding.placements(mesh, s)))
        split += any(e is not None for e in s)
    walk(cache, want, cspecs)
    out["prefill_" + arch] = [err(logits, want_logits), max(leaves),
                              laid_out, split, len(leaves),
                              float(want_logits.abs().max())]
    # one decode step at the next position, on each cache
    tok = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4,)))
    _, want_logits, want = steps.make_serve_step(model)(params, want, tok,
                                                        12)
    pt = sharding.place({"t": tok}, mesh, specs_mod.batch_shardings(
        mesh, {"t": tok}))["t"]
    with implicit_replication():
        _, logits, cache = steps.make_serve_step(model)(pp, cache, pt, 12)
    leaves, laid_out, split = [], True, 0
    walk(cache, want, cspecs)
    out["decode_" + arch] = [err(logits, want_logits), max(leaves),
                             laid_out, float(want_logits.abs().max())]
emit(out)
"""


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return run_ranks(_LAYOUTS, 8, tmp_path_factory.mktemp("layouts"),
                     timeout=300.0)


@pytest.mark.parametrize("vocab", [256, 250])
def test_vocab_parallel_loss_equals_the_plain_one(layouts, vocab):
    for r in layouts:
        loss_err, h_err, w_err, loss = r[f"loss_{vocab}"]
        assert loss_err <= 1e-6 * max(1.0, abs(loss)), (loss_err, loss)
        assert h_err <= 1e-6 and w_err <= 1e-6, (h_err, w_err)


@pytest.mark.parametrize("vocab", [256, 250])
def test_vocab_parallel_loss_never_makes_the_logits_whole(layouts, vocab):
    for r in layouts:
        assert r[f"loss_{vocab}_whole_vocab"] == []
        # the max, the partition and the gold logit, each all-reduced
        # over the vocab's ranks at the local (batch, chunk) shape
        rows = r[f"loss_{vocab}_logit_collectives"]
        assert {x["kind"] for x in rows} == {"all-reduce"}
        assert sum(x["count"] for x in rows if x["phase"] == "forward") == 3


def test_moe_on_dtensors_equals_the_plain_forward(layouts):
    for r in layouts:
        out_err, aux_err, x_err, w_err, scale = r["moe"]
        assert out_err <= 1e-6 * max(1.0, scale), out_err
        assert aux_err <= 1e-6 and x_err <= 1e-6 and w_err <= 1e-6, r["moe"]


def test_moe_dispatch_buffer_is_split_over_data_and_model(layouts):
    for r in layouts:
        assert r["moe_xe"], "the DTensor path did not dispatch"
        for whole, local, places in r["moe_xe"]:
            assert places == [["Shard", 0], ["Shard", 1]], places
            n_whole = n_local = 1
            for a, b in zip(whole, local):
                n_whole, n_local = n_whole * a, n_local * b
            assert n_local * 2 * 4 == n_whole, (whole, local)


def test_mamba2_on_dtensors_equals_the_plain_forward(layouts):
    """Forward, prefill state and gradients of a Mamba2 mixer whose input
    projection (296 columns: z 128, x 128, B 16, C 16, dt 8) is split over
    4 model ranks at 74 columns, across its pieces' boundaries; the state
    comes out as the cache holds it (conv inputs over the model ranks,
    the scan's heads too)."""
    for r in layouts:
        y_err, conv_err, ssm_err, x_err, w_err, scale, width, local = \
            r["mamba2"]
        assert (width, local) == (296, 74)
        assert y_err <= 1e-5 * max(1.0, scale), y_err
        assert max(conv_err, ssm_err, x_err, w_err) <= 1e-5, r["mamba2"]
        assert r["mamba2_state_places"] == [[["Shard", 0], ["Shard", 2]],
                                            [["Shard", 0], ["Shard", 1]]]


def test_mamba2_moves_no_tensor_of_the_projection_width(layouts):
    """No collective moves the whole projection (296 wide), and nothing of
    three or more dims (an activation: the projection's columns, the
    scan's heads) is gathered over the model ranks: the columns go where
    the pieces' even split puts them (an all-to-all), B and C whole (an
    all-reduce of their 32 columns)."""
    for r in layouts:
        rows = r["mamba2_collectives"]
        assert {x["kind"] for x in rows if x["phase"] == "forward"} == {
            "all-to-all", "all-reduce"}, rows
        assert not [x for x in rows if 296 in x["shape"]], rows
        assert not [x for x in rows if x["kind"] == "all-gather"
                    and x["axis"] == "model" and len(x["shape"]) >= 3], rows


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-7b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "whisper-large-v3", "rwkv6-1.6b"])
def test_prefill_on_the_mesh_lays_out_the_cache_by_its_specs(layouts, arch):
    for r in layouts:
        logit_err, cache_err, laid_out, split, n, scale = \
            r["prefill_" + arch]
        assert laid_out and split == n, (arch, split, n)
        assert logit_err <= 1e-5 * max(1.0, scale), (arch, logit_err)
        assert cache_err <= 1e-5, (arch, cache_err)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-7b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "whisper-large-v3", "rwkv6-1.6b"])
def test_decode_on_the_mesh_writes_the_cache_shard_by_shard(layouts, arch):
    for r in layouts:
        logit_err, cache_err, laid_out, scale = r["decode_" + arch]
        assert laid_out, arch
        assert logit_err <= 1e-5 * max(1.0, scale), (arch, logit_err)
        assert cache_err <= 1e-5, (arch, cache_err)


def _whole_heads(rows, heads, width):
    """The collectives of `rows` that gather over the model ranks, or move
    a tensor holding every head (or every repeated KV head: `heads` of
    them) or a projection's every column (`width`)."""
    return [x for x in rows
            if x["kind"] == "all-gather" and x["axis"] == "model"
            or heads in x["shape"][:2] or width in x["shape"]]


@pytest.mark.parametrize("case", ["padded", "gqa"])
def test_attention_on_dtensors_equals_the_plain_forward(layouts, case):
    """`attention.forward` (projections, `split_heads`, `chunked_attention`,
    the output projection) with 6 heads over 4 model ranks, every head its
    own KV head ("padded": ranks hold 2, 2, 2, 0 heads) or 2 KV heads
    ("gqa": 1, 1, 0, 0), and `chunked_attention` itself on q, k and v so
    split: outputs and gradients equal the plain ones within 1e-5."""
    for r in layouts:
        y_err, x_err, w_err, scale = r["attn_" + case]
        assert y_err <= 1e-5 * max(1.0, scale), r["attn_" + case]
        assert x_err <= 1e-5 and w_err <= 1e-5, r["attn_" + case]
        o_err, g_err, scale, places = r["chunked_" + case]
        assert o_err <= 1e-5 * max(1.0, scale), r["chunked_" + case]
        assert g_err <= 1e-5, r["chunked_" + case]
        assert places == [["Shard", 0], ["Shard", 1]], places


@pytest.mark.parametrize("case", ["padded", "gqa"])
def test_attention_moves_no_tensor_of_every_head(layouts, case):
    """No collective gathers over the model ranks, and none moves every
    head (or every repeated KV head) or the projection's every column:
    each rank receives its heads' columns, and the KV heads its query
    heads read, through all-to-alls of only those (none at all where each
    rank holds what it reads)."""
    for r in layouts:
        for key in ("attn_", "chunked_"):
            rows = r[key + case + "_collectives"]
            assert not _whole_heads(rows, 6, 6 * 16), rows
            assert {x["kind"] for x in rows if x["axis"] == "model"} <= {
                "all-to-all"}, rows
        assert [x for x in r["attn_" + case + "_collectives"]
                if x["kind"] == "all-to-all"], "nothing routed by heads"
    # the padded heads' K and V are where their query heads are
    if case == "padded":
        for r in layouts:
            assert r["chunked_padded_collectives"] == []


def test_whisper_cross_attention_over_split_frames(layouts):
    """Whisper's cross-attention with the encoder memory's frames split
    over the model ranks (as `cache_specs` splits the decode cache's 16
    frames over 4): output and gradients equal the plain ones within
    1e-5 (the products run on the memory's own shards; DTensor's would
    flatten the split frames, which torch 2.11 refuses); and the decode
    cache holds its memory so split."""
    for r in layouts:
        y_err, x_err, m_err, w_err, scale = r["cross"]
        assert y_err <= 1e-5 * max(1.0, scale), r["cross"]
        assert max(x_err, m_err, w_err) <= 1e-5, r["cross"]
        assert r["whisper_memory"] == [["Shard", 0], ["Shard", 1]]
