"""approx_ffn: the kernel-backed workload (port of
`examples/apps/approx_ffn.py`).

A small transformer block whose approximated region runs on the port's
kernels:

    x --taf_matmul--> proj --perforated_attention--> ctx --iact_rowfn--> y

The spec's technique selects which stage is approximated; the others run
exact in plain PyTorch, as the JAX package computes them outside any
kernel:

  TAF          -- the (S, d) x (d, d) projection via the TAF matmul kernel
                  (block-level output memoization over row blocks);
  IACT         -- the FFN tile via the iACT kernel (memo table, majority
                  vote, single-writer insert);
  PERFORATION  -- self-attention via the perforated attention kernel
                  (herded KV-block dropping; masked mode for fractions).

Substrates (`core/substrate.py`): "cuda" runs the kernels, "host" the plain
oracles of `kernels/ref.py` with identical block semantics -- the parity
reference for outputs, approx masks and QoI error. Both run on the app's
`device` (``cuda`` unless the caller passes ``"cpu"``; on the CPU the
kernel wrappers take their plain versions).

Inputs come from numpy `RandomState` exactly as the JAX app makes them, so
the two apps compute on the same data. QoI: the block's output
activations. Error: MAPE. `flop_fraction` carries the structural savings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import convert, device as device_mod
from ..core import batching
from ..core import perforation as perfo_mod
from ..core import substrate as substrate_mod
from ..core.harness import AppResult, ApproxApp
from ..core.types import ApproxSpec, Technique
from ..kernels import ref
from ..obs import timing

# Block geometry: fixed by the app (structural; not part of the spec grid).
# Approx masks are block-granular, so a non-default geometry joins the
# workload fingerprint.
_BLOCK_M = 16      # taf_matmul row block => seq/16 temporal steps
_BLOCK_ROWS = 16   # iact_rowfn rows per table block
_BLOCK_ATTN = 32   # attention q/kv block => seq/32 KV blocks


def _blocks3(blocks):
    """(block_m, block_rows, block_attn) -- module defaults when None."""
    return (_BLOCK_M, _BLOCK_ROWS, _BLOCK_ATTN) if blocks is None \
        else tuple(blocks)


def gen_inputs(seq: int, d: int, seed: int = 0) -> np.ndarray:
    """(seq, d) with row-BLOCK temporal locality: rows within a 16-row block
    are near-identical and successive blocks drift on a slow random walk, so
    TAF's window RSD and iACT's distance threshold discriminate across the
    sweep grids."""
    rng = np.random.RandomState(seed)
    n_blocks = seq // _BLOCK_M
    base = rng.randn(1, d).astype(np.float32)
    drift = np.cumsum(0.04 * rng.randn(n_blocks, 1, d), axis=0)
    blocks = base[None] + drift.astype(np.float32)           # (B, 1, d)
    x = np.repeat(blocks, _BLOCK_M, axis=1).reshape(seq, d)
    x = x + 0.01 * rng.randn(seq, d).astype(np.float32)
    return x.astype(np.float32)


def host_arrays(seq: int, d: int, d_h: int, seed: int
                ) -> Tuple[np.ndarray, ...]:
    """(x, wp, w1, w2) as float32 numpy, made as the JAX app's `_arrays`
    makes them (the scaled weights are computed in float64 and rounded to
    float32, as `jnp.asarray` rounds them)."""
    rng = np.random.RandomState(seed + 1)
    x = gen_inputs(seq, d, seed)
    wp = rng.randn(d, d).astype(np.float32) / np.sqrt(d)
    w1 = rng.randn(d, d_h).astype(np.float32) / np.sqrt(d)
    w2 = rng.randn(d_h, d).astype(np.float32) / np.sqrt(d_h)
    return tuple(a.astype(np.float32) for a in (x, wp, w1, w2))


def split_heads(p: torch.Tensor, heads: int) -> torch.Tensor:
    s, d = p.shape
    return p.reshape(s, heads, d // heads).transpose(0, 1)[None]


def merge_heads(a: torch.Tensor) -> torch.Tensor:
    _, h, s, dh = a.shape
    return a[0].transpose(0, 1).reshape(s, h * dh)


def attn_exact(p: torch.Tensor, heads: int) -> torch.Tensor:
    q = split_heads(p, heads)
    return merge_heads(ref.attention_ref(q, q, q, causal=True))


def ffn_exact(a: torch.Tensor, w1, w2) -> torch.Tensor:
    return ref.gelu_tanh(a @ w1) @ w2


def kernel_operands(seq: int, d: int, d_h: int, heads: int, seed: int = 0,
                    device=None) -> dict:
    """The operands each kernel takes on the app's path at this geometry:
    `x`, `wp` (TAF projection), the exact attention output `a` with `w1`,
    `w2` (iACT FFN) and the per-head projection `q` (attention, q = k = v).
    """
    x, wp, w1, w2 = convert.ffn_arrays(*host_arrays(seq, d, d_h, seed),
                                       device=device)
    p = x @ wp
    return dict(x=x, wp=wp, w1=w1, w2=w2,
                q=split_heads(p, heads).contiguous(),
                a=attn_exact(p, heads).contiguous())


def _flops(seq: int, d: int, d_h: int) -> Tuple[float, float, float]:
    """(proj, attn, ffn) accurate-path FLOPs (causal factor ignored: it is
    common to numerator and denominator of flop_fraction)."""
    proj = 2.0 * seq * d * d
    attn = 4.0 * seq * seq * d
    ffn = 2.0 * seq * d * d_h + 2.0 * seq * d_h * d
    return proj, attn, ffn


def _flop_fraction(technique: Technique, approx_frac, seq, d, d_h):
    proj, attn, ffn = _flops(seq, d, d_h)
    total = proj + attn + ffn
    if technique == Technique.TAF:
        exec_ = proj * (1.0 - approx_frac) + attn + ffn
    elif technique == Technique.IACT:
        exec_ = proj + attn + ffn * (1.0 - approx_frac)
    elif technique == Technique.PERFORATION:
        exec_ = proj + attn * (1.0 - approx_frac) + ffn
    else:
        exec_ = total
    return max(float(exec_ / total), 1e-3)


def make_app(substrate: Optional[str] = None, seq: int = 128, d: int = 32,
             d_h: int = 64, heads: int = 2, seed: int = 0, blocks=None,
             device=None) -> ApproxApp:
    """`substrate=None` resolves the ambient default ONCE, at construction
    (it is part of the workload fingerprint). `blocks`: None (module
    default geometry) or an explicit (block_m, block_rows, block_attn)
    tuple. `device`: ``cuda`` unless the caller passes ``"cpu"``."""
    dev = device_mod.resolve(device)
    sub = substrate_mod.resolve(substrate)
    if blocks is not None:
        blocks = tuple(int(b) for b in blocks)
        if blocks == _blocks3(None):
            blocks = None  # identical geometry: keep the default fingerprint
    block_m, block_rows, block_attn = _blocks3(blocks)
    if seq % block_m or seq % block_rows or seq % block_attn:
        raise ValueError(
            f"approx_ffn blocks (block_m={block_m}, block_rows={block_rows},"
            f" block_attn={block_attn}) must divide seq={seq}")
    if d % heads:
        raise ValueError(f"heads={heads} must divide d={d}")
    x, wp, w1, w2 = convert.ffn_arrays(*host_arrays(seq, d, d_h, seed),
                                       device=dev)

    def exact():
        return ffn_exact(attn_exact(x @ wp, heads), w1, w2)

    def cuda_eval(spec: ApproxSpec, knob):
        """(qoi, approx_frac, mask) on the kernels; `knob` is a float32
        device tensor, or None for skip-driven perforation."""
        t = spec.technique
        if t == Technique.TAF:
            p, mask = substrate_mod.taf_matmul_region(
                x, wp, spec, block_m=block_m, block_n=d, rsd_threshold=knob)
            qoi = ffn_exact(attn_exact(p, heads), w1, w2)
            return qoi, mask.float().mean(), mask
        if t == Technique.IACT:
            a = attn_exact(x @ wp, heads)
            qoi, mask = substrate_mod.iact_ffn_region(
                a, w1, w2, spec, block_rows=block_rows, threshold=knob)
            return qoi, mask.float().mean(), mask
        if t == Technique.PERFORATION:
            q = split_heads(x @ wp, heads)
            o, kept = substrate_mod.attention_region(
                q, q, q, spec, block_q=block_attn, block_kv=block_attn,
                fraction=knob)
            qoi = ffn_exact(merge_heads(o), w1, w2)
            return qoi, 1.0 - kept.float().mean(), ~kept
        raise ValueError(f"no kernel evaluator for {t}")

    def host_eval(spec: ApproxSpec):
        t = spec.technique
        if t == Technique.TAF:
            p, mask = ref.taf_matmul_ref(
                x, wp, block_m=block_m, block_n=d,
                history_size=spec.taf.history_size,
                prediction_size=spec.taf.prediction_size,
                rsd_threshold=spec.taf.rsd_threshold)
            qoi = ffn_exact(attn_exact(p, heads), w1, w2)
        elif t == Technique.IACT:
            a = attn_exact(x @ wp, heads)
            qoi, mask = ref.iact_rowfn_ref(
                a, w1, w2, block_rows=block_rows,
                table_size=spec.iact.table_size,
                threshold=spec.iact.threshold)
        elif t == Technique.PERFORATION:
            q = split_heads(x @ wp, heads)
            o = ref.attention_ref(q, q, q, causal=True, block_kv=block_attn,
                                  perfo=spec.perforation)
            qoi = ffn_exact(merge_heads(o), w1, w2)
            mask = torch.as_tensor(
                ~perfo_mod.execute_mask(seq // block_attn, spec.perforation))
        else:
            raise ValueError(f"no host evaluator for {t}")
        return qoi, mask.float().mean(), mask

    def _result(spec, qoi, frac, mask, wall):
        frac = float(frac)
        return AppResult(
            qoi=qoi.cpu().numpy() if isinstance(qoi, torch.Tensor) else qoi,
            wall_time_s=wall, approx_fraction=frac,
            flop_fraction=_flop_fraction(spec.technique, frac, seq, d, d_h),
            extra={"approx_mask":
                   np.asarray(mask.cpu() if isinstance(mask, torch.Tensor)
                              else mask).astype(int).ravel().tolist()})

    def run(spec: ApproxSpec) -> AppResult:
        # one warm-up call before the timed one, so first-use costs (the
        # kernels' build and load) never land in the timed window
        if spec.technique == Technique.NONE:
            m = timing.measure(exact, device=dev, warmup=1, repeats=1)
            return _result(spec, m.value, 0.0, np.zeros((0,)), m.seconds)
        if sub == substrate_mod.HOST:
            m = timing.measure(host_eval, spec, device=dev, warmup=1,
                               repeats=1)
        else:
            knob = None
            if batching.static_key(spec) is not None:
                knob = torch.tensor(batching.traced_param(spec),
                                    dtype=torch.float32, device=dev)
            m = timing.measure(cuda_eval, spec, knob, device=dev, warmup=1,
                               repeats=1)
        qoi, frac, mask = m.value
        return _result(spec, qoi, frac, mask, m.seconds)

    run_batch = None
    if sub == substrate_mod.CUDA:
        def make_group_fn(key):
            spec = batching.spec_from_key(key)

            def group(knobs):
                # one lane after another: each kernel launches once a lane
                outs = [cuda_eval(spec, knobs[lane])
                        for lane in range(knobs.shape[0])]
                qois, fracs, masks = (torch.stack(z) for z in zip(*outs))
                return qois, fracs, {"approx_mask": masks}
            return group

        def result_builder(qoi, frac, extra, wall, spec):
            mask = np.asarray(extra.get("approx_mask", np.zeros((0,))))
            return _result(spec, qoi, frac, mask, wall)

        run_batch = batching.make_run_batch(run, make_group_fn,
                                            result_builder=result_builder,
                                            device=dev)

    workload = dict(substrate=sub, seq=seq, d=d, d_h=d_h, heads=heads,
                    seed=seed)
    if blocks is not None:
        workload["blocks"] = list(blocks)
    return ApproxApp(name="approx_ffn", run=run, error_metric="mape",
                     run_batch=run_batch, workload=workload)
