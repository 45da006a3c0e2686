"""``python -m deepspeed_tpu_torch.analysis`` — the port's hazard linter CLI
(counterpart of ``deepspeed_tpu/analysis/__main__.py``).

Exit codes: 0 clean (every finding suppressed by pragma or baseline),
1 unsuppressed findings, 2 usage error. ``--write-baseline`` accepts the
current findings as intentional and rewrites the baseline file.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

from . import baseline as baseline_mod
from .cache import LintCache, default_cache_path, lint_paths_cached
from .lint import lint_paths
from .rules import ALL_RULE_IDS, RULES


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.analysis",
        description="Hazard linter over deepspeed_tpu_torch: host syncs and "
                    "fresh allocations in serving and training hot paths, "
                    "untyped raises, nondeterministic scheduler decisions, "
                    "open transfer tickets, mutate-before-raise. DSTPU004 "
                    "(retrace hazards) is the JAX package's only: the port "
                    "traces nothing, and the program audit's trace bound "
                    "takes its place.")
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to lint "
                        "(default: ./deepspeed_tpu_torch)")
    p.add_argument("--rules", default=None, metavar="IDS",
                   help="comma-separated rule ids to run "
                        f"(default: all of {','.join(ALL_RULE_IDS)})")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppression baseline file (default: the packaged "
                        "analysis/baseline.txt; 'none' disables)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept current findings as intentional: rewrite "
                        "the baseline and exit 0")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a machine-readable JSON object: findings "
                        "array + run summary (CI consumers key on "
                        ".findings[].rule / .summary.unsuppressed)")
    p.add_argument("--check-programs", action="store_true",
                   help="program-audit dry mode (no torch import): "
                        "verify analysis/programs.json parses, pins every "
                        "audited_program registration under PATHS, and "
                        "carries no stale entries; exit 1 on drift")
    p.add_argument("--programs", default=None, metavar="FILE",
                   help="program manifest for --check-programs (default: "
                        "the packaged analysis/programs.json)")
    p.add_argument("--cache", default=None, metavar="FILE", nargs="?",
                   const=default_cache_path(),
                   help="mtime-keyed finding cache: unchanged files lint "
                        "from the cache (default file: "
                        f"{default_cache_path()}; invalidated by file "
                        "edits, rule-set changes, and linter upgrades)")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the finding cache even if one exists")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the summary line")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rid in ALL_RULE_IDS:
            r = RULES[rid]
            scope = "/".join(r.scope) if r.scope else "whole tree"
            print(f"{rid}  {r.title}  [scope: {scope}]")
        print("DSTPU004  not ported: the port traces nothing; an extra step "
              "program fails the program audit's trace bound "
              "(analysis/program_audit.py)")
        return 0

    paths = args.paths or (["deepspeed_tpu_torch"]
                           if os.path.isdir("deepspeed_tpu_torch") else [])
    if not paths:
        print("dstpu-lint: no paths given and no ./deepspeed_tpu_torch here",
              file=sys.stderr)
        return 2
    for p in paths:
        if not os.path.exists(p):
            print(f"dstpu-lint: no such path: {p}", file=sys.stderr)
            return 2

    if args.check_programs:
        from .program_audit import check_manifest
        problems = check_manifest(paths, args.programs)
        for msg in problems:
            print(msg)
        if not args.quiet:
            print(f"dstpu-lint: program manifest "
                  f"{'DRIFTED' if problems else 'consistent'} "
                  f"({len(problems)} problem"
                  f"{'' if len(problems) == 1 else 's'})")
        return 1 if problems else 0

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip().upper() for r in args.rules.split(",")
                    if r.strip()]
        unknown = [r for r in rule_ids if r not in RULES]
        if unknown:
            print(f"dstpu-lint: unknown rule id(s): {', '.join(unknown)} "
                  f"(known: {', '.join(ALL_RULE_IDS)})", file=sys.stderr)
            return 2

    cache = None
    if args.cache is not None and not args.no_cache:
        cache = LintCache(args.cache)
        findings = lint_paths_cached(paths, rule_ids, cache)
    else:
        findings = lint_paths(paths, rule_ids)

    baseline_path = args.baseline or baseline_mod.default_path()
    if args.write_baseline:
        if args.baseline == "none":
            print("dstpu-lint: --write-baseline needs a real baseline path "
                  "(got 'none')", file=sys.stderr)
            return 2
        n = baseline_mod.save(baseline_path, findings)
        if not args.quiet:
            print(f"dstpu-lint: wrote {n} baseline entr"
                  f"{'y' if n == 1 else 'ies'} to {baseline_path}")
        return 0

    if args.baseline == "none":
        unsuppressed, stale = findings, set()
    else:
        keys = baseline_mod.load(baseline_path)
        unsuppressed, stale = baseline_mod.apply(findings, keys)

    if args.as_json:
        print(json.dumps({
            "version": 1,
            "findings": [{
                "path": f.path, "line": f.line, "col": f.col,
                "rule": f.rule, "message": f.message, "hint": f.hint,
                "qualname": f.qualname,
            } for f in unsuppressed],
            "summary": {
                "unsuppressed": len(unsuppressed),
                "suppressed": len(findings) - len(unsuppressed),
                "stale_baseline": sorted("\t".join(k) for k in stale),
            },
        }, indent=2))
    else:
        for f in unsuppressed:
            print(f.render())

    if not args.quiet and not args.as_json:
        bits = [f"{len(unsuppressed)} finding"
                f"{'' if len(unsuppressed) == 1 else 's'}",
                f"{len(findings) - len(unsuppressed)} suppressed"]
        if stale:
            bits.append(f"{len(stale)} stale baseline entr"
                        f"{'y' if len(stale) == 1 else 'ies'} "
                        "(prune with --write-baseline)")
        if cache is not None:
            bits.append(f"cache {cache.hits} hit"
                        f"{'' if cache.hits == 1 else 's'}/"
                        f"{cache.misses} miss"
                        f"{'' if cache.misses == 1 else 'es'}")
        print(f"dstpu-lint: {', '.join(bits)}")
    return 1 if unsuppressed else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
