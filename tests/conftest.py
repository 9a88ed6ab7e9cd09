"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 device (the 512-device override belongs to repro.launch.dryrun only).
"""
import os
import sys

# Allow `pytest tests/` without PYTHONPATH=src.
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if os.path.abspath(_SRC) not in [os.path.abspath(p) for p in sys.path]:
    sys.path.insert(0, os.path.abspath(_SRC))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute subprocess tests (forced multi-device meshes, "
        "full decode loops); run in tier-1, deselectable with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _fresh_tt_plan_memo():
    """The process-wide TT plan memo (kernels.plan) caches resolutions by
    chain signature; tests that monkeypatch the fit model or redirect the
    autotune cache must not see (or leave behind) memoized plans."""
    from repro.kernels import plan
    plan.clear_plan_memo()
    yield
    plan.clear_plan_memo()
