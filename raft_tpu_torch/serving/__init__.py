"""The serving stack of the PyTorch/CUDA port (SERVING.md).

The port's copy of the JAX package's ``serving/``: a bounded admission
queue with deadlines and 429 load shedding, a dynamic micro-batcher that
coalesces requests into pre-declared (resolution-bucket x batch-step)
shapes, a warm engine that captures one CUDA graph per shape before the
first request and only replays them after (``engine.py``), stdlib
Prometheus-text observability over ``http.server``, and the sessionful
streaming path (``/v1/stream``: sessions batched over a slot pool in CUDA
memory, ``session.py``/``stream.py``).  ``python -m raft_tpu_torch.serving``
starts a server (``__main__.py``).
"""

from .batcher import (BatcherCrashed, MicroBatcher, NonFiniteOutput,
                      PoisonedRequest)
from .breaker import BreakerOpen, CircuitBreaker
from .config import ServeConfig, default_batch_steps, parse_buckets
from .engine import InferenceEngine
from .faults import (BatcherKilled, ChaosSpec, FaultInjected, FaultInjector,
                     make_injector, parse_chaos_spec)
from .metrics import (Counter, Gauge, Histogram, Registry,
                      make_serving_metrics, make_stream_metrics)
from .queue import (DeadlineExceeded, Draining, QueueFull, RejectedError,
                    Request, RequestQueue)
from .server import BatcherSupervisor, FlowServer, serve_cli
from .session import Session, SessionStore, SlotPool
from .stream import (SessionBusy, StreamCoordinator, StreamRequest,
                     UnknownSession)
