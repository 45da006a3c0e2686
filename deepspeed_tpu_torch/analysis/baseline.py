"""Suppression baseline for the port's DSTPU linter (counterpart of
``deepspeed_tpu/analysis/baseline.py``).

The baseline is the checked-in inventory of *intentional* findings — e.g.
the one designed device-to-host copy per engine step. Entries key on
``(rule, normalized path, qualname, stripped source line)`` so renames of
unrelated code and ordinary line drift never invalidate them; editing the
flagged line itself does, which is exactly when a human should re-decide.

Format: one tab-separated entry per line, ``#`` comments and blanks
ignored. ``save`` writes sorted + deduplicated, so regenerating with
``--write-baseline`` produces minimal diffs.
"""

import os
from typing import Iterable, List, Set, Tuple

from .lint import Finding

Key = Tuple[str, str, str, str]

_HEADER = """\
# dstpu-lint suppression baseline of deepspeed_tpu_torch.
# One intentional finding per line: rule<TAB>path<TAB>qualname<TAB>source,
# each under a comment line that says why it stays.
# Regenerate with: python -m deepspeed_tpu_torch.analysis --write-baseline
# (that drops the reasons: put them back before committing).
"""


def default_path() -> str:
    """The packaged baseline shipped next to this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def load(path: str) -> Set[Key]:
    """Load baseline keys; a missing file is an empty baseline."""
    keys: Set[Key] = set()
    if not os.path.exists(path):
        return keys
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 4:
                raise ValueError(
                    f"{path}: malformed baseline entry (want 4 tab-"
                    f"separated fields): {line!r}")
            keys.add(tuple(parts))  # type: ignore[arg-type]
    return keys


def save(path: str, findings: Iterable[Finding]) -> int:
    """Write the baseline covering ``findings``; returns the entry count."""
    keys = sorted({f.key() for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(_HEADER)
        for k in keys:
            fh.write("\t".join(x.replace("\t", " ") for x in k) + "\n")
    return len(keys)


def apply(findings: Iterable[Finding],
          keys: Set[Key]) -> Tuple[List[Finding], Set[Key]]:
    """Split findings against the baseline: returns ``(unsuppressed,
    stale_keys)`` where stale keys matched nothing (their hazard was fixed
    or the line changed — prune them with ``--write-baseline``)."""
    unsuppressed: List[Finding] = []
    used: Set[Key] = set()
    for f in findings:
        k = f.key()
        if k in keys:
            used.add(k)
        else:
            unsuppressed.append(f)
    return unsuppressed, keys - used
