"""mtime-keyed finding cache for the port's DSTPU linter (counterpart of
``deepspeed_tpu/analysis/cache.py``).

Repo-wide lint is the tier-1 gate; re-parsing every file on every
``dstpu-lint`` run makes the pre-commit hook unpleasant. The cache keys
each file's findings on ``(mtime_ns, size, rule set)`` plus a *linter
signature* — the mtimes/sizes of the analysis package's own sources — so
editing the linter (or the rule catalog) invalidates everything, while an
untouched tree lints from pure dict lookups.

Only per-file lint results are cached; the two suppression tiers (inline
pragmas live in the cached findings, the baseline is applied by the
caller) and exit-code policy are computed fresh every run. The linter
signature nonetheless covers the package's checked-in *data* files too —
``baseline.txt`` and ``programs.json`` — so a baseline re-pin or a
program-manifest update flushes the cache outright: belt and braces
against any consumer that snapshots suppressed-or-not into its own
artifacts. A corrupt or version-skewed cache file is ignored, never an
error.
"""

import json
import os
from dataclasses import asdict
from typing import Dict, Iterable, List, Optional

from .lint import Finding, iter_python_files, lint_file

_VERSION = 1


def default_cache_path(start: str = ".") -> str:
    """``build/lint_cache.json`` under ``start`` (the port's git-ignored
    build directory)."""
    return os.path.join(start, "build", "lint_cache.json")


#: non-``.py`` package files that shape lint/audit outcomes: an edited
#: baseline or a re-pinned program manifest must invalidate the cache
#: exactly like a linter upgrade
_DATA_FILES = ("baseline.txt", "programs.json")


def _linter_signature() -> List[List[object]]:
    """(name, mtime_ns, size) for every source — and checked-in data
    file — of this package: a new linter version or a baseline/manifest
    re-pin must never serve stale findings."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    sig: List[List[object]] = []
    for name in sorted(os.listdir(pkg)):
        if not (name.endswith(".py") or name in _DATA_FILES):
            continue
        st = os.stat(os.path.join(pkg, name))
        sig.append([name, st.st_mtime_ns, st.st_size])
    return sig


class LintCache:
    """Load/validate/update one cache file. ``get`` misses (returns None)
    whenever the file's stat or the requested rule set changed."""

    def __init__(self, path: str):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._files: Dict[str, dict] = {}
        self._dirty = False
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
            if (data.get("version") == _VERSION
                    and data.get("linter_sig") == _linter_signature()):
                self._files = data.get("files", {})
        except (OSError, ValueError):
            pass  # missing/corrupt cache = cold cache

    @staticmethod
    def _stat_key(path: str) -> Optional[List[int]]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return [st.st_mtime_ns, st.st_size]

    def get(self, path: str, rule_key: List[str]) -> Optional[List[Finding]]:
        entry = self._files.get(os.path.abspath(path))
        if entry is None:
            return None
        if entry["stat"] != self._stat_key(path) or entry["rules"] != rule_key:
            return None
        return [Finding(**f) for f in entry["findings"]]

    def put(self, path: str, rule_key: List[str],
            findings: List[Finding]) -> None:
        self._files[os.path.abspath(path)] = {
            "stat": self._stat_key(path), "rules": rule_key,
            "findings": [asdict(f) for f in findings]}
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"version": _VERSION,
                       "linter_sig": _linter_signature(),
                       "files": self._files}, fh)
        os.replace(tmp, self.path)


def lint_paths_cached(paths: Iterable[str], rule_ids: Optional[Iterable[str]],
                      cache: LintCache) -> List[Finding]:
    """Cache-aware :func:`deepspeed_tpu_torch.analysis.lint.lint_paths` — same
    contract (inline-suppressed findings dropped), unchanged files served
    from the cache."""
    rule_key = sorted(rule_ids) if rule_ids is not None else ["*"]
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        cached = cache.get(f, rule_key)
        if cached is None:
            cache.misses += 1
            cached = lint_file(f, rule_ids)
            cache.put(f, rule_key, cached)
        else:
            cache.hits += 1
        findings.extend(x for x in cached if not x.suppressed_inline)
    cache.save()
    return findings
