"""Shared test configuration.

Enables JAX's persistent compilation cache for the suite: the tier-1 tests
are dominated by XLA compiles of `lax.scan` simulation programs and reduced
model train steps, so re-runs (local dev loops, CI retries on a warm cache
volume) skip straight to execution.  The cache key includes the HLO and
compile options, so it is safe across code changes — edits simply miss.
"""
from __future__ import annotations

import os

import jax

_CACHE_DIR = os.environ.get(
    "STEAMX_JAX_CACHE",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))

try:
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    # default only caches >1s compiles; tier-1 has many ~0.5s scan programs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
except Exception:  # pragma: no cover - older jax without these flags
    pass

# subprocess-based tests (test_elastic, test_distributed) spawn fresh python
# interpreters that never import this conftest; the env vars hand them the
# same cache
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _CACHE_DIR)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")


# ---------------------------------------------------------------------------
# golden regression fixtures (tests/golden/*.json)
# ---------------------------------------------------------------------------

import json

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def pytest_addoption(parser):
    parser.addoption(
        "--update-golden", action="store_true", default=False,
        help="rewrite tests/golden/*.json from the current run instead of "
             "comparing against it (then commit the diff deliberately)")


def _jsonable(tree):
    """Nested namedtuples/dicts of arrays -> plain JSON-serializable dicts.

    None-valued fields are dropped: disabled-by-default optional outputs
    (e.g. SimResult.probes) serialize as ABSENT, so adding such a field
    keeps every golden snapshot byte-identical."""
    if hasattr(tree, "_asdict"):
        return {k: _jsonable(v) for k, v in tree._asdict().items()
                if v is not None}
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items() if v is not None}
    return np.asarray(tree).tolist()


def _compare(got, want, rtol, atol, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            f"golden field mismatch at {path}: {sorted(set(got) ^ set(want))} "
            f"(run `pytest --update-golden` if the schema change is intended)")
        for k in want:
            _compare(got[k], want[k], rtol, atol, f"{path}.{k}")
    else:
        np.testing.assert_allclose(
            np.asarray(got, np.float64), np.asarray(want, np.float64),
            rtol=rtol, atol=atol,
            err_msg=f"golden drift at {path} — if the metric change is "
                    f"intended, regenerate with `pytest --update-golden` "
                    f"and commit the new snapshot")


@pytest.fixture
def golden(request):
    """Compare a (nested-namedtuple) result against tests/golden/<name>.json.

    `golden(name, result)` fails on silent metric drift; `pytest
    --update-golden` rewrites the snapshots instead (and skips, so an update
    run cannot green-wash a broken comparison)."""
    update = request.config.getoption("--update-golden")

    def check(name, tree, rtol=1e-4, atol=1e-8):
        path = os.path.join(GOLDEN_DIR, name + ".json")
        data = _jsonable(tree)
        if update:
            os.makedirs(GOLDEN_DIR, exist_ok=True)
            with open(path, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
                f.write("\n")
            pytest.skip(f"golden '{name}' regenerated")
        assert os.path.exists(path), (
            f"missing golden snapshot {path}: generate it once with "
            f"`pytest --update-golden` and commit it")
        with open(path) as f:
            want = json.load(f)
        _compare(data, want, rtol, atol, name)

    return check


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself when "
        "torch.cuda.is_available() is false")
