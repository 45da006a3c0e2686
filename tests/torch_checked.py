"""Checked mode for the port's serving and training test modules.

The counterpart of ``_SANITIZE_FILES`` in ``tests/conftest.py``: a module
that imports :func:`checked_mode` runs every test with
``DSTPU_SANITIZE=1``, so the port's engine builds the self-verifying KV
cache, every ``Request.state`` assignment is validated and the scheduler
runs its between-steps and drain checks on each workload the module drives.
The variable is the JAX package's too, so the JAX engines those modules
build are checked as their own suites are. An explicit ``DSTPU_SANITIZE``
in the environment (``DSTPU_SANITIZE=0`` to bisect) wins.
"""

import os

import pytest


@pytest.fixture(autouse=True)
def checked_mode(monkeypatch):
    if "DSTPU_SANITIZE" not in os.environ:
        monkeypatch.setenv("DSTPU_SANITIZE", "1")
    yield
