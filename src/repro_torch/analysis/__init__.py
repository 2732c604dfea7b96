"""repro_torch.analysis -- the machine profiles, the cost model and
approxlint (port of `repro.analysis`).

  machine   -- named roofline profiles (the H100 and the host simulator),
               `measure_machine` to calibrate the running device
  cost      -- `kernel_cost`, `trace_cost` and the app cost model
  errorprop -- relative-error propagation over eager programs (A007)

approxlint, over what PyTorch gives (the ops an eager program dispatches,
and on the card CUDA-graph capture), with the JAX package's rules:

  A001  recompile-leak: a quality knob shapes the program
  A002  substrate/kernel misconfiguration
  A003  unsafe approximation sink (taint into host reads / indices)
  A004  QoS ladder validity (saved policy files)
  A005  sharding placement (the sharded engine's leaves)
  A006  ladder rung with predicted sub-1x speedup on the target machine
  A007  approximation error amplifying unboundedly through a loop carry
  A008  instrumentation safety (obs hooks that read or keep device values)

CLI: ``python -m repro_torch.analysis.lint --apps all [--device cpu]``.
Programmatic: `run_lint`; opt-in hooks: `harness.run_specs(lint=True)`,
`ServingEngine(..., lint=True)`.
"""
from . import cost, machine  # noqa: F401
from .findings import Allowlist, Finding, Report, Severity  # noqa: F401


def __getattr__(name):
    # Lazy: `python -m repro_torch.analysis.lint` imports this package
    # first; an eager import of `lint` here would double-import it.
    if name == "run_lint":
        from .lint import run_lint
        return run_lint
    if name in ("RULE_IDS", "check_engine_placement", "check_policy_file",
                "check_policy_cost", "check_divergence"):
        from . import rules
        return getattr(rules, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
