"""The port's instruments: the JAX package's ``tools/`` on the PyTorch/CUDA
port, one module each, run as ``python -m raft_tpu_torch.tools.<name>``
(each keeps the name of its JAX counterpart):

* :mod:`serve_bench` — the serving load generator (closed and open loops,
  ``--smoke``, ``--video``, ``--chaos``, ``--coldstart``, ``--fleet``,
  ``--ragged-sweep``);
* :mod:`tlm` — the run-log reader (``tail``, ``summary``, ``compare``,
  ``trace``, ``top``);
* :mod:`bench_train` — the captured train step's throughput;
* :mod:`profile_breakdown` — the per-iteration slope and intercept, and the
  model's parts alone;
* :mod:`envelope_check` — the chairs recipe's memory at accumulation 1
  against N, one executed step, the loader's rate;
* :mod:`warmstart_bench` — cold against warm-start evaluation on a
  fabricated Sintel tree;
* :mod:`train_chaos` — the training plane's fault drill;
* :mod:`make_qualitative` — the flow panel from a checkpoint.

Each runs on the card unless ``--cpu`` is given, and writes its records
under ``build/port_tools/`` by default.  Importing a module here imports
torch, numpy and the port only.
"""
