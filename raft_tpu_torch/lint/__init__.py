"""raftlint for the port: the JAX package's ``lint/`` on PyTorch and CUDA.

* :mod:`.engine` + :mod:`.rules` — the AST hazard analysis (no torch
  import; the scanned code is never executed): the port's R1-R8 and K1
  (captured regions, graphs built per call, global RNG, float64 and TF32,
  ``torch.where``, static outputs after a replay, the detached iterate,
  kernel twins), and R9, R10, C1-C6, B1-B5 as the JAX package has them.
* :mod:`.budget` — the warm grid the engine consumes, the device memory
  and the CUDA graph pools priced on fake tensors, and the kernels' shared
  memory, thread and register envelopes against the H100's limits.
* :mod:`.concurrency` — the ``guarded_by`` annotations, the serving lock
  hierarchy and the class/lock analysis behind C1-C6.
* :mod:`.contracts` — ``@contract`` shape/dtype specs on the hot path.

Command line: ``python -m raft_tpu_torch.tools.raftlint``; the catalog
and its mapping to the JAX rules: ``RULES.md`` beside this file."""
