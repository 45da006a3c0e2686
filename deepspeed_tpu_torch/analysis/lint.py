"""AST linter for serving and training hazards in the port (counterpart of
``deepspeed_tpu/analysis/lint.py``).

Pure static analysis: no torch import, no execution of the linted code.
``lint_paths`` walks ``.py`` files, parses each once, and runs six rule
families over the tree (the JAX linter's seven less DSTPU004):

- **DSTPU001** host-device syncs inside the serving and training hot
  functions: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()``, an event's or stream's
  ``.synchronize()``, and ``np.asarray`` (of a tensor, it waits for the
  device).
- **DSTPU002** fresh array construction (``torch.zeros`` and the rest of
  its family, ``np.zeros`` & friends) in those same step functions.
- **DSTPU003** untyped ``raise RuntimeError``-style raises and
  string-matched exception dispatch (``"..." in str(e)``) in the
  serve/inference/resilience layers.
- **DSTPU005** nondeterminism in scheduler/resilience decision logic:
  ``time.time()``, unseeded ``random.*``, global ``np.random.*`` and
  ``torch.rand*`` state, direct iteration over sets; and across the
  serve/inference/resilience layers, threefry ``PRNGKey``/``split`` calls
  and ``manual_seed`` calls whose key material flows from the wall clock,
  process entropy or global RNG state.
- **DSTPU006** transfer-ticket discipline: a ``.value`` read on a
  ``submit_d2h`` ticket, or on a ``submit_h2d(..., settle=False)`` ticket,
  still open on the path (no dominating ``drain_before``/``wait``). A plain
  ``submit_h2d`` settles at submit and is exempt; escape via ``return`` is
  ownership transfer.
- **DSTPU007** mutate-before-raise in the serve/inference hot functions: a
  ``raise`` reached after a ``self.*`` state write on the same path.

DSTPU004 (retrace hazards in ``jax.jit``-traced code) is not here: the
port traces nothing, and an extra step program fails the program audit's
trace bound (``program_audit.py``).

Suppression is two-tier: an inline ``# dstpu-lint: ignore[DSTPU00X]``
pragma on the flagged line, and the checked-in baseline
(``analysis/baseline.txt``) keyed on (rule, path, qualname, source text).
"""

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from .rules import (ALLOC_NAMES_BY_ROOT, DRAIN_CALLS, HOT_FUNCTIONS,
                    KEY_HAZARD_CALLS, RNG_KEY_BASES, RNG_KEY_SCOPE, RULES,
                    SEEDED_RNG, STDLIB_RANDOM_LEAVES, SYNC_ATTRS,
                    SYNC_ATTRS_NOARG, SYNC_DOTTED, TORCH_GLOBAL_RNG,
                    UNTYPED_RAISES)

_PRAGMA = re.compile(r"#\s*dstpu-lint:\s*ignore(?:\[([A-Za-z0-9,\s]+)\])?")

#: the package root that baseline keys are relative to
_PKG = "deepspeed_tpu_torch"


@dataclass
class Finding:
    """One lint hit: location, rule, message, and remediation hint."""

    path: str           # path as scanned (absolute or as given)
    norm_path: str      # location-independent path used for baseline keys
    line: int
    col: int
    rule: str
    message: str
    hint: str
    qualname: str       # enclosing Class.function chain or <module>
    line_text: str      # stripped source of the flagged line
    suppressed_inline: bool = field(default=False)

    def key(self) -> Tuple[str, str, str, str]:
        """Baseline identity — survives line-number drift."""
        return (self.rule, self.norm_path, self.qualname, self.line_text)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}\n    hint: {self.hint}")


def _norm_path(path: str) -> str:
    """Key paths on the ``deepspeed_tpu_torch/...`` suffix when present
    (stable across checkouts and working directories); fall back to the
    basename for loose files."""
    parts = path.replace(os.sep, "/").split("/")
    if _PKG in parts:
        return "/".join(parts[len(parts) - 1 - parts[::-1].index(_PKG):])
    return parts[-1]


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _in_scope(path_parts: Sequence[str], scope: Sequence[str]) -> bool:
    return not scope or any(p in path_parts for p in scope)


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as written."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _dotted(node.func) == "torch.device"
            and bool(node.args) and _is_cpu_device(node.args[0]))


def _is_open_submit(node: ast.AST) -> bool:
    """A submit whose ticket stays open until drained: every
    ``submit_d2h``, and a ``submit_h2d`` with ``settle=`` not literally
    True."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr == "submit_d2h":
        return True
    if node.func.attr != "submit_h2d":
        return False
    for kw in node.keywords:
        if kw.arg == "settle":
            return not (isinstance(kw.value, ast.Constant) and kw.value.value is True)
    return False


# ---------------------------------------------------------------------------
# the per-file visitor
# ---------------------------------------------------------------------------

class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, lines: List[str], rule_ids: Set[str]):
        self.path = path
        self.norm = _norm_path(path)
        self.parts = self.norm.split("/")
        self.lines = lines
        self.rule_ids = rule_ids
        self.findings: List[Finding] = []
        self._hot: List[bool] = []        # per enclosing function: hot?
        self._names: List[str] = []       # Class/function qualname stack
        self._classes: List[Optional[str]] = []  # the class a def sits in
        self._except_depth = 0

    # -- helpers ---------------------------------------------------------
    def _enabled(self, rule: str) -> bool:
        return (rule in self.rule_ids
                and _in_scope(self.parts, RULES[rule].scope))

    def _qualname(self) -> str:
        return ".".join(self._names) or "<module>"

    def _line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def _pragma_rules(self, lineno: int) -> Optional[Set[str]]:
        """Rules suppressed by an inline pragma on ``lineno`` (empty set =
        all rules), or None when there is no pragma."""
        m = _PRAGMA.search(self._line_text(lineno))
        if not m:
            return None
        if not m.group(1):
            return set()
        return {r.strip().upper() for r in m.group(1).split(",")}

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        pragma = self._pragma_rules(node.lineno)
        self.findings.append(Finding(
            path=self.path, norm_path=self.norm, line=node.lineno,
            col=node.col_offset, rule=rule, message=message,
            hint=RULES[rule].hint, qualname=self._qualname(),
            line_text=self._line_text(node.lineno),
            suppressed_inline=(pragma is not None
                               and (not pragma or rule in pragma)),
        ))

    def _in_hot_function(self) -> bool:
        return any(self._hot)

    def _is_hot(self, node: ast.AST) -> bool:
        cls = self._classes[-1] if self._classes else None
        return (node.name in HOT_FUNCTIONS
                or (cls is not None and f"{cls}.{node.name}" in HOT_FUNCTIONS))

    # -- structure -------------------------------------------------------
    def _visit_func(self, node: ast.AST) -> None:
        hot = self._is_hot(node)
        self._hot.append(hot)
        self._names.append(node.name)
        self._classes.append(None)  # a def nested in this one has no class
        if self._enabled("DSTPU006"):
            self._check_transfer_discipline(node)
        if self._enabled("DSTPU007") and hot:
            self._check_mutate_before_raise(node)
        self.generic_visit(node)
        self._classes.pop()
        self._names.pop()
        self._hot.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._names.append(node.name)
        self._classes.append(node.name)
        self.generic_visit(node)
        self._classes.pop()
        self._names.pop()

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._except_depth += 1
        self.generic_visit(node)
        self._except_depth -= 1

    # -- rule checks -----------------------------------------------------
    def _sync_name(self, node: ast.Call, d: Optional[str],
                   attr: Optional[str]) -> Optional[str]:
        """The host sync this call is, or None."""
        if d in SYNC_DOTTED or attr in SYNC_ATTRS:
            return d or attr
        if attr in SYNC_ATTRS_NOARG and not node.args and not node.keywords:
            return attr
        if attr == "to" and (
                (node.args and _is_cpu_device(node.args[0]))
                or any(kw.arg == "device" and _is_cpu_device(kw.value)
                       for kw in node.keywords)):
            return 'to("cpu")'
        return None

    def visit_Call(self, node: ast.Call) -> None:
        d = _dotted(node.func)
        attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                else None)
        hot = self._in_hot_function()

        if self._enabled("DSTPU001") and hot:
            sync = self._sync_name(node, d, attr)
            if sync is not None:
                self._emit(node, "DSTPU001",
                           f"host sync `{sync}(...)` inside hot "
                           f"function `{self._qualname()}` — this blocks "
                           "the dispatch pipeline once per step")

        if self._enabled("DSTPU002") and hot and d is not None:
            root, _, leaf = d.partition(".")
            if leaf in ALLOC_NAMES_BY_ROOT.get(root, ()):
                self._emit(node, "DSTPU002",
                           f"fresh array `{d}(...)` allocated every "
                           f"iteration of hot function "
                           f"`{self._qualname()}`")

        if self._enabled("DSTPU005") and d is not None:
            if d == "time.time":
                self._emit(node, "DSTPU005",
                           "wall-clock `time.time()` in decision logic — "
                           "not injectable, not monotonic")
            elif d.startswith("random."):
                self._emit(node, "DSTPU005",
                           f"unseeded stdlib RNG `{d}(...)` — decisions "
                           "must replay from a seed")
            elif (d.startswith(("np.random.", "numpy.random."))
                  and d.split(".")[-1] not in SEEDED_RNG):
                self._emit(node, "DSTPU005",
                           f"global-state RNG `{d}(...)` — use a seeded "
                           "np.random.default_rng instance")
            elif d in TORCH_GLOBAL_RNG and not any(
                    kw.arg == "generator" for kw in node.keywords):
                self._emit(node, "DSTPU005",
                           f"global-state RNG `{d}(...)` — pass a seeded "
                           "torch.Generator")

        if "DSTPU005" in self.rule_ids and (d is not None or attr == "manual_seed"):
            # key material: its own scope, wherever sampled decode runs (a
            # generator's seed may hang off a call: Generator().manual_seed)
            base, _, leaf = (d or f"<call>.{attr}").rpartition(".")
            if (((leaf in ("PRNGKey", "split", "fold_in", "key")
                  and base in RNG_KEY_BASES)
                 or leaf == "manual_seed")
                    and _in_scope(self.parts, RNG_KEY_SCOPE)):
                hazard = self._key_material_hazard(node)
                if hazard is not None:
                    self._emit(node, "DSTPU005",
                               f"`{d or attr}(...)` key material flows from "
                               f"nondeterministic `{hazard}(...)` — sampled "
                               "tokens could never replay bitwise; derive "
                               "keys counter-based: "
                               "fold_in(PRNGKey(request_seed), position)")
        self.generic_visit(node)

    @staticmethod
    def _key_material_hazard(node: ast.Call) -> Optional[str]:
        """First nondeterministic source call found in the key-material
        argument expressions of a key or seed call, or None. Constants,
        carried names, arithmetic, and counter-based ``fold_in`` chains
        all pass — only a hazard CALL in the dataflow flags."""
        for arg in (*node.args, *(kw.value for kw in node.keywords)):
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                sd = _dotted(sub.func)
                if sd is None:
                    continue
                if sd in KEY_HAZARD_CALLS:
                    return sd
                root, _, sleaf = sd.partition(".")
                if root == "random" and sleaf in STDLIB_RANDOM_LEAVES:
                    return sd
                if (sd.startswith(("np.random.", "numpy.random."))
                        and sd.split(".")[-1] not in SEEDED_RNG):
                    return sd
                if sd in TORCH_GLOBAL_RNG:
                    return sd
        return None

    def visit_Raise(self, node: ast.Raise) -> None:
        if self._enabled("DSTPU003") and node.exc is not None:
            target = node.exc.func if isinstance(node.exc, ast.Call) \
                else node.exc
            d = _dotted(target)
            if d in UNTYPED_RAISES:
                self._emit(node, "DSTPU003",
                           f"untyped `raise {d}` — the scheduler cannot "
                           "dispatch on this without string matching")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if (self._enabled("DSTPU003") and self._except_depth > 0
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops)):
            for side in (node.left, *node.comparators):
                if (isinstance(side, ast.Call)
                        and _dotted(side.func) == "str"):
                    self._emit(node, "DSTPU003",
                               "string-matched exception dispatch "
                               "(`... in str(e)`) — match the type, not "
                               "the message")
                    break
        self.generic_visit(node)

    def _set_iter_check(self, it: ast.AST) -> None:
        if (isinstance(it, ast.Set)
                or (isinstance(it, ast.Call)
                    and _dotted(it.func) == "set")):
            self._emit(it, "DSTPU005",
                       "iteration over a set — ordering is "
                       "hash-randomized across runs; sort it or use a "
                       "list/dict")

    def visit_For(self, node: ast.For) -> None:
        if self._enabled("DSTPU005"):
            self._set_iter_check(node.iter)
        self.generic_visit(node)

    # -- DSTPU006: transfer-ticket discipline ----------------------------
    def _check_transfer_discipline(self, fn: ast.AST) -> None:
        """Path-sensitive statement walk over ONE function body (nested
        defs are analyzed on their own visit): a name bound from
        ``submit_d2h(...)`` or ``submit_h2d(..., settle=False)`` is an
        *open* ticket until a drain/wait settles it; reading ``.value``
        while open is the undrained-dependent-read
        hazard the runtime's ``TransferTicket.value`` only catches at
        execution time. A plain ``submit_h2d`` settles at submit and never flags;
        escape via ``return``/storage is ownership transfer (the consumer
        drains) and is legal."""

        def scan_expr(node: ast.AST, opens: Set[str]) -> None:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and sub.attr == "value":
                    if _is_open_submit(sub.value):
                        self._emit(sub, "DSTPU006",
                                   "`.value` read directly on the "
                                   f"`{sub.value.func.attr}(...)` result — the ticket "
                                   "is still open; this forces an inline "
                                   "sync and defeats the overlap")
                    elif (isinstance(sub.value, ast.Name)
                          and sub.value.id in opens):
                        self._emit(sub, "DSTPU006",
                                   f"`.value` read on open TransferTicket "
                                   f"`{sub.value.id}` with no dominating "
                                   "drain on this path")
                elif isinstance(sub, ast.Call):
                    d = _dotted(sub.func) or ""
                    if d.split(".")[-1] not in DRAIN_CALLS:
                        continue
                    mentioned = {n.id for a in (*sub.args,
                                                *(k.value
                                                  for k in sub.keywords))
                                 for n in ast.walk(a)
                                 if isinstance(n, ast.Name)}
                    if isinstance(sub.func, ast.Attribute) and isinstance(
                            sub.func.value, ast.Name):
                        mentioned.add(sub.func.value.id)  # t.wait()
                    if mentioned & opens:
                        opens.difference_update(mentioned)
                    else:
                        # a blanket drain (drain_all, or tickets reached
                        # through a container) settles everything in flight
                        opens.clear()

        def walk(stmts: Sequence[ast.stmt], opens: Set[str]) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.If):
                    scan_expr(st.test, opens)
                    o1, o2 = set(opens), set(opens)
                    walk(st.body, o1)
                    walk(st.orelse, o2)
                    opens.clear()
                    opens.update(o1 | o2)
                elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                    scan_expr(st.iter if isinstance(
                        st, (ast.For, ast.AsyncFor)) else st.test, opens)
                    o = set(opens)
                    walk(st.body, o)
                    walk(st.orelse, o)
                    opens.update(o)
                elif isinstance(st, ast.Try):
                    walk(st.body, opens)
                    for h in st.handlers:
                        oh = set(opens)
                        walk(h.body, oh)
                        opens.update(oh)
                    walk(st.finalbody, opens)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        scan_expr(item.context_expr, opens)
                    walk(st.body, opens)
                elif (isinstance(st, ast.Assign) and len(st.targets) == 1
                      and isinstance(st.targets[0], ast.Name)):
                    scan_expr(st.value, opens)
                    if _is_open_submit(st.value):
                        opens.add(st.targets[0].id)
                    else:
                        opens.discard(st.targets[0].id)  # rebinding
                else:
                    scan_expr(st, opens)

        walk(fn.body, set())

    # -- DSTPU007: mutate-before-raise exception safety ------------------
    def _check_mutate_before_raise(self, fn: ast.AST) -> None:
        """Per-hot-function path walk: a ``raise`` reached after a
        ``self.*`` state write on the same path leaves the engine
        half-mutated. Exempt: numeric-literal counter bumps
        (``self.stat += 1`` — monotonic bookkeeping, not state), bare
        re-raises, raises inside a ``try`` that has handlers (the
        rollback pattern), and sibling branches (mutation in one ``if``
        arm never taints a ``raise`` in the other)."""

        def mutation_of(st: ast.stmt) -> Optional[str]:
            if isinstance(st, ast.Assign):
                targets = st.targets
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                targets = [st.target]
            elif isinstance(st, ast.Delete):
                targets = st.targets
            else:
                return None
            if (isinstance(st, ast.AugAssign)
                    and isinstance(st.value, ast.Constant)
                    and isinstance(st.value.value, (int, float))):
                return None  # counter bump
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if not isinstance(base, ast.Attribute):
                    continue
                root = base.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "self":
                    return _dotted(base) or "self.<attr>"
            return None

        Mutation = Tuple[int, str]

        def merge(a: List[Mutation], b: List[Mutation]) -> List[Mutation]:
            return a + [m for m in b if m not in a]

        def walk(stmts: Sequence[ast.stmt], mutated: List[Mutation],
                 exempt: bool) -> List[Mutation]:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.Raise):
                    if st.exc is not None and mutated and not exempt:
                        line, desc = mutated[0]
                        self._emit(st, "DSTPU007",
                                   f"`raise` after state write `{desc}` "
                                   f"(line {line}) in hot function "
                                   f"`{self._qualname()}` — an exception "
                                   "here leaves the engine half-mutated")
                    continue
                desc = mutation_of(st)
                if desc is not None:
                    mutated = mutated + [(st.lineno, desc)]
                elif isinstance(st, ast.If):
                    m1 = walk(st.body, list(mutated), exempt)
                    m2 = walk(st.orelse, list(mutated), exempt)
                    mutated = merge(m1, m2)
                elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                    m = walk(st.body, list(mutated), exempt)
                    mutated = merge(mutated, walk(st.orelse, m, exempt))
                elif isinstance(st, ast.Try):
                    # a try WITH handlers is the rollback idiom: raises in
                    # its body are assumed handled/rolled back there
                    m = walk(st.body, list(mutated),
                             exempt or bool(st.handlers))
                    for h in st.handlers:
                        walk(h.body, [], exempt)
                    mutated = walk(st.finalbody, merge(mutated, m), exempt)
                elif isinstance(st, (ast.With, ast.AsyncWith)):
                    mutated = walk(st.body, mutated, exempt)
            return mutated

        walk(fn.body, [], False)

    def _visit_comp(self, node) -> None:
        if self._enabled("DSTPU005"):
            for gen in node.generators:
                self._set_iter_check(gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str,
                rule_ids: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint one file's source text. Inline-pragma'd findings are returned
    with ``suppressed_inline=True`` (callers filter); a syntax error
    yields a single DSTPU000 finding so broken files fail gates loudly."""
    ids = set(rule_ids) if rule_ids is not None else set(RULES)
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(
            path=path, norm_path=_norm_path(path), line=e.lineno or 0,
            col=e.offset or 0, rule="DSTPU000",
            message=f"file does not parse: {e.msg}",
            hint="fix the syntax error", qualname="<module>",
            line_text="")]
    visitor = _FileLint(path, lines, ids)
    visitor.visit(tree)
    visitor.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return visitor.findings


def lint_file(path: str,
              rule_ids: Optional[Iterable[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path, rule_ids)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def lint_paths(paths: Iterable[str],
               rule_ids: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every ``.py`` under ``paths`` (files or directory trees).
    Inline-suppressed findings are dropped here; baseline suppression is
    the caller's second tier (``baseline.apply``)."""
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(x for x in lint_file(f, rule_ids)
                        if not x.suppressed_inline)
    return findings
