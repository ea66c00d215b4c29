"""The port's AOT engine cache (``raft_tpu_torch/serving/aot_cache.py``)
against the JAX package's, on the CPU: the key schema and the entry names
equal the JAX package's; a cold then a warm ``InferenceEngine`` (raft-small,
1 iteration, bucket 32x48, streaming on: a 9-key grid) hit on every key
with bitwise the cold engine's outputs, within the full-model bound
``1e-3 + 1e-3 * max|flow|`` of ``raft_tpu``'s ``make_inference_fn`` on the
same converted weights; every kind of staleness (the identity, the
weights, an entry) misses with a warning and leaves the outputs
unchanged; a prestage writes the missing entries; the kernel objects live
in the cache per source digest, so two digests never share one.  On the
CPU the factories run eager, so a key's probe digest is of the plain
versions' output; nothing here builds a kernel (a stand-in command writes
the kernel objects)."""

import dataclasses
import json
import logging
import shutil
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.config import RAFTConfig as JaxConfig
from raft_tpu.lint.budget import enumerate_warmup_grid as jax_grid
from raft_tpu.models.raft import make_inference_fn as jax_inference_fn
from raft_tpu.serving import ServeConfig as JaxServeConfig
from raft_tpu.serving import aot_cache as jax_cache
import raft_tpu_torch as rt
from raft_tpu_torch import _build
from raft_tpu_torch.lint.budget import enumerate_warmup_grid as port_grid
from raft_tpu_torch.serving import FlowServer, InferenceEngine, ServeConfig
from raft_tpu_torch.serving import aot_cache
from test_torch_port_pack import seeded_jax_params

torch.set_num_threads(2)   # several test workers share the host's cores

BUCKET = (32, 48)
JCFG = JaxConfig.small_model(iters=1)
PCFG = rt.RAFTConfig.small_model(iters=1)
SERVE = dict(buckets=(BUCKET,), max_batch=2, max_sessions=2)
N_KEYS = 9      # pair x2, encode, stream, szero, sbatch x2, scommit x2
TIMEOUT = 30


@pytest.fixture(scope="module", autouse=True)
def build_root():
    """An engine with a cache points ``_build`` at the cache's kernels;
    the module leaves it where it found it."""
    root = _build.BUILD_ROOT
    yield
    _build.use_root(root)


@pytest.fixture(scope="module")
def weights():
    params = seeded_jax_params(JCFG, seed=7)
    model = rt.RAFT(PCFG)
    model.load_state_dict(rt.from_jax_params(params), strict=True)
    return params, model.eval()


def frames(seed, n=1):
    return np.random.RandomState(seed).rand(2, n, *BUCKET, 3).astype(np.float32)


def engine(model, root, **kw):
    """A warmed engine with a cache in ``root`` (None: no cache)."""
    sc = ServeConfig(**SERVE, **kw)
    # keyed by the configuration the engine serves (the server resolves
    # the policy override the same way)
    cfg = dataclasses.replace(PCFG, iters_policy=sc.iters_policy or
                              PCFG.iters_policy)
    cache = (aot_cache.EngineCache(root, cfg, model) if root is not None
             else None)
    eng = InferenceEngine(PCFG, model, sc, iters=1, stream=True, cache=cache)
    assert eng.warmup(verbose=False) == N_KEYS
    return eng


def outputs(eng):
    """The engine's pair flows at batch 1 and 2 and one stream step."""
    a, b = frames(31, 2)
    enc = eng.run_encode(BUCKET, a[:1])
    step = eng.run_stream(BUCKET, b[:1], *enc,
                          np.zeros((1, 4, 6, 2), np.float32))
    return [eng.run(BUCKET, a[:1], b[:1]), eng.run(BUCKET, a, b), step[0],
            step[1]]


@pytest.fixture(scope="module")
def cold(weights, tmp_path_factory):
    """A directory a cold engine filled, that engine, and its outputs."""
    root = tmp_path_factory.mktemp("cache")
    eng = engine(weights[1], root)
    return root, eng, outputs(eng)


def test_key_schema_and_entry_names_equal_jax():
    assert aot_cache.KEY_FIELDS == jax_cache.KEY_FIELDS
    assert aot_cache.MANIFEST_NAME == jax_cache.MANIFEST_NAME
    keys = set()
    for kw in (SERVE, dict(SERVE, iters_policy="converge:0.05:3"),
               dict(SERVE, iters_policy="converge:0.5"),
               dict(buckets=((16, 24), (32, 48)), max_batch=3,
                    max_sessions=2, ragged=True,
                    iters_policy="converge:1e-3:2")):
        got, want = port_grid(PCFG, ServeConfig(**kw)), jax_grid(
            JCFG, JaxServeConfig(**kw))
        assert got == want
        keys |= set(got)
    keys |= {("pair", 432, 1024, 4, "fixed"),
             ("sbatch", 440, 1248, 2, "converge:0.05:3"),
             ("pair", 8, 8, 1, "weird policy/with:chars")}
    assert any(k[4].startswith("converge:") for k in keys)
    for key in sorted(keys):
        assert aot_cache.key_filename(key) == jax_cache.key_filename(key)
    assert len({aot_cache.key_filename(k) for k in keys}) == len(keys)


def test_cold_then_warm_hits_every_key_bitwise_and_matches_jax(weights, cold,
                                                                tmp_path):
    params, model = weights
    root, cold_eng, want = cold
    st = cold_eng.cache.stats
    assert (st.hits, st.misses, st.saves) == (0, N_KEYS, N_KEYS)
    man = json.loads((cold_eng.cache.dir / "manifest.json").read_text())
    assert man["key_fields"] == list(aot_cache.KEY_FIELDS)
    assert sorted(man["entries"]) == sorted(
        aot_cache.key_filename(k) for k in port_grid(PCFG, ServeConfig(**SERVE)))
    warm_root = tmp_path / "warm"
    shutil.copytree(root, warm_root)
    warm = engine(model, warm_root)
    st = warm.cache.stats
    assert (st.hits, st.misses, st.loads, st.saves, st.mismatches) == (
        N_KEYS, 0, N_KEYS, 0, 0)
    assert warm.warmup_loaded == N_KEYS
    assert [k["hit"] for k in warm.boot["keys"]] == [True] * N_KEYS
    for got, ref in zip(outputs(warm), want):
        np.testing.assert_array_equal(got, ref)
    # the JAX package's forward on the same weights, jitted
    a, b = frames(31, 2)
    jflow = np.asarray(jax.jit(jax_inference_fn(JCFG))(
        params, jnp.asarray(a), jnp.asarray(b)))
    bound = 1e-3 + 1e-3 * float(np.abs(jflow).max())
    assert float(np.abs(want[1] - jflow).max()) <= bound


def _stale_field(d):
    man = json.loads((d / "manifest.json").read_text())
    man["cudnn_version"] = 1
    (d / "manifest.json").write_text(json.dumps(man))


def _version_bump(d):
    man = json.loads((d / "manifest.json").read_text())
    man["version"] = aot_cache.MANIFEST_VERSION + 1
    (d / "manifest.json").write_text(json.dumps(man))


def _corrupt_entry(d):
    (d / aot_cache.key_filename(("pair", *BUCKET, 2, "fixed"))).write_bytes(
        b"\x00not json")


def _foreign_digest(d):
    path = d / aot_cache.key_filename(("stream", *BUCKET, 1, "fixed"))
    entry = json.loads(path.read_text())
    entry["digest"] = "0" * 64
    path.write_text(json.dumps(entry))


STALE = {
    # case: (edit of the directory, misses, warning, whether the entries
    # are written anew)
    "stale_field": (_stale_field, N_KEYS, "stale cudnn_version", True),
    "version_bump": (_version_bump, N_KEYS, "manifest version", True),
    "corrupt_entry": (_corrupt_entry, 1, "corrupt entry", True),
    "foreign_digest": (_foreign_digest, 1, "differs from the writer", False),
    "changed_config": (None, N_KEYS, "no manifest", True),
    "new_weights": (None, N_KEYS, "stale weights_digest", True),
    "compiler_ran": ("compile", N_KEYS, "ran the compiler", False),
}


@pytest.mark.parametrize("case", list(STALE))
def test_every_staleness_misses_with_a_warning_and_same_results(
        case, weights, cold, tmp_path, caplog, monkeypatch):
    _, model = weights
    root, _, want = cold
    edit, misses, warning, rewritten = STALE[case]
    d = tmp_path / "c"
    shutil.copytree(root, d)
    sub = next(p for p in d.iterdir() if p.is_dir())
    kw = {}
    if case == "changed_config":
        # another policy is another configuration: another directory
        kw = dict(iters_policy="converge:0.5:1")
    elif case == "new_weights":
        # a probe's output depends on the weights: the same directory, cold
        model = rt.init_raft_torch(PCFG, torch.Generator().manual_seed(3),
                                   device="cpu")
    elif edit == "compile":
        real = aot_cache.EngineCache.__init__

        def attach_then_compile(self, *a, **k):
            real(self, *a, **k)
            monkeypatch.setattr(_build, "COMPILER_RUNS",
                                _build.COMPILER_RUNS + 1)
        monkeypatch.setattr(aot_cache.EngineCache, "__init__",
                            attach_then_compile)
    else:
        edit(sub)
    with caplog.at_level(logging.WARNING, logger=aot_cache._log.name):
        eng = engine(model, d, **kw)
    st = eng.cache.stats
    assert (st.misses, st.hits) == (misses, N_KEYS - misses)
    assert st.mismatches == (case == "foreign_digest")
    assert warning in caplog.text
    assert st.saves == (misses if rewritten else 0)
    if case in ("changed_config", "new_weights"):
        assert (eng.cache.dir == sub) == (case == "new_weights")
        return
    for got, ref in zip(outputs(eng), want):
        np.testing.assert_array_equal(got, ref)
    if case == "foreign_digest":      # the writer's entry is kept
        path = sub / aot_cache.key_filename(("stream", *BUCKET, 1, "fixed"))
        assert json.loads(path.read_text())["digest"] == "0" * 64


def test_prestage_fills_missing_entries_over_http(weights, cold, tmp_path):
    _, model = weights
    root, _, _ = cold
    d = tmp_path / "c"
    shutil.copytree(root, d)
    sub = next(p for p in d.iterdir() if p.is_dir())
    gone = sorted(sub.glob("s*.bin"))
    assert len(gone) == 6             # stream, szero, sbatch x2, scommit x2
    for p in gone:
        p.unlink()
    sc = ServeConfig(**SERVE, port=0, engine_cache_dir=str(d),
                     history_interval_s=0)
    server = FlowServer(PCFG, model, sc, iters=1)
    server.start()
    try:
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=TIMEOUT) as r:
            ec = json.loads(r.read())["engine_cache"]
        assert (ec["hits"], ec["misses"], ec["saves"]) == (3, 6, 6)
        assert ec["dir"] == str(sub) and ec["compiler_runs"] == 0
        for p in gone[:3]:
            p.unlink()
        req = urllib.request.Request(server.url + "/admin/cache/prestage",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            out = json.loads(r.read())
        assert out["status"] == "prestaged"
        assert out["cache"] == {"exported": N_KEYS, "entries": N_KEYS,
                                "dir": str(sub)}
        assert all(p.exists() for p in gone)
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=TIMEOUT) as r:
            text = r.read().decode()
        assert "raft_engine_cache_hits_total 3" in text
        assert "raft_engine_cache_misses_total 6" in text
        assert "raft_engine_cache_load_seconds_count 3" in text
    finally:
        server.stop(drain=False)
    # a cacheless server answers 409, as the JAX package's does
    plain = FlowServer(PCFG, model, ServeConfig(**SERVE, port=0,
                                                history_interval_s=0),
                       iters=1)
    plain.start()
    try:
        req = urllib.request.Request(plain.url + "/admin/cache/prestage",
                                     data=b"", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert e.value.code == 409
    finally:
        plain.stop(drain=False)


def test_kernel_objects_shared_per_source_digest(cold, monkeypatch):
    """An engine that attaches a cache builds into and loads from its
    ``kernels/<digest>/``.  The first build there runs the compiler (a
    stand-in command here: no ``nvcc`` on the CPU), a later one from the
    same sources finds the objects and runs none, and sources of another
    digest build into a directory of their own, leaving the first digest's
    objects as they were."""
    root, eng, _ = cold
    _build.use_root(root / "elsewhere")
    eng._prepare_kernels()
    assert _build.build_dir() == root / aot_cache.KERNELS_DIR / _build._digest()
    assert eng.cache.kernels is None        # the CPU runs no kernel

    def fake_compiler(source, out):
        return [sys.executable, "-c", f"open({str(out)!r}, 'w').write("
                f"{(_build._digest() + ' ' + source)!r})"]
    monkeypatch.setattr(_build, "_command", fake_compiler)
    objects = {}
    for digest in ("aaaaaaaaaaaaaaaa", "bbbbbbbbbbbbbbbb"):
        monkeypatch.setattr(_build, "_digest", lambda d=digest: d)
        runs = _build.COMPILER_RUNS
        libs = _build.build(_build.SOURCES)
        assert _build.COMPILER_RUNS == runs + len(_build.SOURCES)
        assert _build.build(_build.SOURCES) == libs        # found: no run
        assert _build.COMPILER_RUNS == runs + len(_build.SOURCES)
        for s, path in libs.items():
            assert path.parent == root / aot_cache.KERNELS_DIR / digest
            assert path.read_text() == f"{digest} {s}"
        objects[digest] = libs
    for digest, libs in objects.items():
        for s, path in libs.items():
            assert path.read_text() == f"{digest} {s}"
