"""Program fingerprints and the knob probe of A001 (port of
`repro.analysis.trace`).

The A001 protocol
-----------------
A quality knob is *properly traced* iff the program a target runs is the
same for every knob value, with the knob entering it as data: the target
is called with the knob as a 0-d tensor argument,

    target(torch.tensor(v))

and run once per value under `KnobTrace`, a `TorchDispatchMode` that
records the program (each op with its tensor operands' dtypes and shapes
and its other operands' values) and follows the knob's taint op by op.
There are three outcomes, each a verdict:

  * equal fingerprints            -> traced (clean): one program, the knob
    a tensor operand, serves every value;
  * the knob reaches a host read  -> static (finding): `float()`,
    `.item()`, `bool()` or `.tolist()` of a knob-derived tensor
    (`aten._local_scalar_dense`) turns the knob into Python control flow
    or a Python constant; each value then runs its own program;
  * differing fingerprints        -> baked (finding): the knob's value was
    captured as a Python number (e.g. before the call), so it shows as a
    literal operand and sweeping it changes the program.

The JAX probe traces with `jax.make_jaxpr`. `torch.fx`'s `make_fx` cannot
serve here: it refuses every host read during a trace, and the port's
eager programs read detector state on the host by design (the decode
step's one read of TAF `remaining`), which says nothing about the knob.
A host read counts only when the value read derives from the knob.

On the card, a kernel's knob is asked in the kernel's own terms
(`probe_graph`): one call is captured in a CUDA graph with the knob in a
device tensor, other values are written into that tensor and the graph is
replayed; each replay must equal an eager call at its value.

Fingerprints normalize hex object addresses, as the JAX fingerprint does.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence

import torch

from .taint import HOST_READS, TaintMode, signature

_HEX_ADDR = re.compile(r"0x[0-9a-fA-F]+")


class KnobTrace(TaintMode):
    """The program one call runs, op by op, and the host reads of values
    derived from the knob."""

    def __init__(self, knob: torch.Tensor):
        super().__init__([knob])
        self.ops: List[str] = []
        self.knob_reads: List[str] = []

    def on_op(self, func, name, args, kwargs, out, hit) -> None:
        text = f"{func}({signature(args)}; {signature(kwargs)})"
        self.ops.append(text)
        if hit and name in HOST_READS:
            self.knob_reads.append(text)


def program_fingerprint(ops: Sequence[str]) -> str:
    """Comparable text of a recorded program, addresses normalized out."""
    return _HEX_ADDR.sub("0x", "\n".join(ops))


@dataclasses.dataclass(frozen=True)
class KnobTraceResult:
    """Outcome of probing one knob on one target."""

    verdict: str                 # "traced" | "static" | "baked" | "error"
    knob_values: Sequence[float]
    error: Optional[str] = None  # for static/error: the read or exception
    diff_excerpt: Optional[str] = None   # for baked: first differing region

    @property
    def clean(self) -> bool:
        return self.verdict == "traced"


def _first_diff(a: str, b: str, context: int = 80) -> str:
    n = min(len(a), len(b))
    i = next((i for i in range(n) if a[i] != b[i]), n)
    lo = max(0, i - context)
    return f"...{a[lo:i + context]}... vs ...{b[lo:i + context]}..."


_STATIC_MARKERS = (
    "data-dependent", "DataDependent", "_local_scalar_dense",
    "static argument",
)


def probe_knob(target: Callable[[torch.Tensor], object],
               knob_values: Sequence[float] = (0.25, 0.75),
               dtype=torch.float32, device=None) -> KnobTraceResult:
    """Run `target` (a function of ONE 0-d knob tensor) at each value and
    classify its program."""
    fingerprints = []
    values = tuple(knob_values)
    try:   # a first call fills what a target caches once per shape
        target(torch.tensor(values[0], dtype=dtype, device=device or "cpu"))
    except Exception:  # noqa: BLE001 - the probe below classifies it
        pass
    for v in values:
        knob = torch.tensor(v, dtype=dtype, device=device or "cpu")
        rec = KnobTrace(knob)
        try:
            with rec:
                target(knob)
        except Exception as e:  # noqa: BLE001 - classify, don't crash
            text = f"{type(e).__name__}: {e}"[:500]
            verdict = ("static" if any(m in text for m in _STATIC_MARKERS)
                       else "error")
            return KnobTraceResult(verdict, values, error=text)
        if rec.knob_reads:
            return KnobTraceResult(
                "static", values,
                error="the knob reaches a host read: "
                      + rec.knob_reads[0][:400])
        fingerprints.append(program_fingerprint(rec.ops))
    if all(f == fingerprints[0] for f in fingerprints[1:]):
        return KnobTraceResult("traced", values)
    return KnobTraceResult("baked", values,
                           diff_excerpt=_first_diff(fingerprints[0],
                                                    fingerprints[1]))


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def _equal(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
    if a.dtype == torch.bool or not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(torch.allclose(a.float(), b.float(), rtol=0.0, atol=atol))


def probe_graph(call: Callable[[torch.Tensor], object],
                knob_values: Sequence[float], atol: float,
                device="cuda") -> KnobTraceResult:
    """A001 of a kernel on the card: capture `call(knob)` (its outputs a
    tensor or a tuple of them; masks are compared bit for bit, float
    outputs within `atol`) once in a CUDA graph with the knob in a device
    tensor at `knob_values[0]`, then write each other value into that
    tensor and replay.

    traced -- every replay equals an eager call at its value;
    baked  -- a replay differs from it (e.g. stays at the captured value);
    static -- the capture raises (a host read or a host-side branch);
    error  -- the values do not move the eager output (nothing to see)."""
    values = tuple(knob_values)
    eager = [_outputs(call(torch.tensor(v, dtype=torch.float32,
                                        device=device))) for v in values]
    torch.cuda.synchronize()
    if all(all(_equal(a, b, atol) for a, b in zip(eager[0], e))
           for e in eager[1:]):
        return KnobTraceResult("error", values,
                               error="the knob values give equal outputs")
    knob = torch.tensor(values[0], dtype=torch.float32, device=device)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(stream):
            call(knob)                 # warm the capture stream
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            captured = _outputs(call(knob))
    except Exception as e:  # noqa: BLE001 - classify, don't crash
        torch.cuda.synchronize()
        return KnobTraceResult("static", values,
                               error=f"{type(e).__name__}: {e}"[:500])
    for v, want in zip(values, eager):
        knob.fill_(v)
        graph.replay()
        torch.cuda.synchronize()
        if not all(_equal(a, b, atol) for a, b in zip(captured, want)):
            return KnobTraceResult(
                "baked", values,
                diff_excerpt=f"replay at {v!r} differs from an eager call "
                             "at that value")
    return KnobTraceResult("traced", values)
