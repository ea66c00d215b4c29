"""Rule plugins: importing this package registers every rule with
``engine.RULES``.  The port's own hazards (captured regions, graphs built
per call, global RNG, float64 and TF32, torch.where, the detached iterate,
kernel twins) sit beside the JAX package's R9, R10, C1-C6 and B1-B5,
copied; RULES.md maps each to its JAX rule."""

from . import (b_budget, c_concurrency, r10_print,  # noqa: F401
               r9_contracts, r_capture, r_torch)
