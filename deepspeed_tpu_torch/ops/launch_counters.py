"""The kernel wrappers' launch counters, in one registry.

Each wrapper keeps its counts as module globals (``paged_attention.launches``,
``woq_gemm.tiled_launches``, ...) and adds one where it launches its kernel.
Each also registers them here when it is imported, so code that must account
for launches it did not make through the wrappers (a CUDA graph's replay runs
no Python) reads and adds to every counter without naming the modules."""

from typing import Dict, List, Sequence, Tuple

_COUNTERS: List[Tuple[Dict, str]] = []


def register(namespace: Dict, *names: str) -> None:
    """Register the counters ``names`` of a module (its ``globals()``)."""
    for name in names:
        if not any(ns is namespace and n == name for ns, n in _COUNTERS):
            _COUNTERS.append((namespace, name))


def names() -> Tuple[str, ...]:
    """``module.counter`` of each registered counter, in :func:`snapshot` order."""
    return tuple(f"{ns['__name__']}.{n}" for ns, n in _COUNTERS)


def snapshot() -> Tuple[int, ...]:
    """Every registered counter's value."""
    return tuple(ns[n] for ns, n in _COUNTERS)


def add(counts: Sequence[int]) -> None:
    """Add ``counts`` (a :func:`snapshot`'s order; a shorter one covers the
    counters registered when it was taken) to the counters."""
    for (ns, n), c in zip(_COUNTERS, counts):
        ns[n] += c
