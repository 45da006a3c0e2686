"""Step-program auditor (counterpart of ``deepspeed_tpu/analysis/program_audit.py``).

The JAX package compiles a fixed set of programs and its audit fingerprints
each one's jaxpr. The port compiles nothing: a step program is a Python
function that launches the step's operations (eagerly, or once before its
CUDA graph is captured). :func:`audited_program` wraps each such function
at its registration site, the counterpart of ``audited_jit``:

- **Off** (``DSTPU_AUDIT`` unset and no :func:`armed` block), the wrapper
  calls the function and nothing else; a CUDA graph's replay does not call
  it at all.
- **Armed**, the first call of each input signature (the dtypes and shapes
  of its tensors and the values of its flags, ``_sig_key``) runs under a
  ``TorchDispatchMode`` that records the program's **fingerprint**: the set
  of dispatcher operations it ran (the port's custom ops under their
  ``dstt::`` names), the deduplicated ``dtype[rank]`` of its tensor inputs
  and outputs, its bf16/fp16 -> fp32 promotions, the kernels whose launch
  counters moved, and its host syncs (``aten::_local_scalar_dense``, the
  ``.item()`` family, or a copy from a CUDA tensor to the CPU; the
  counterpart of the JAX audit's host callbacks). Shapes are collapsed to
  ranks and operations to a set, so the fingerprint does not depend on the
  model's width or depth. The count of distinct signatures is the
  program's trace count. The fingerprint is taken on an eager call only:
  a call made while a CUDA graph is being captured is not recorded, and a
  replay runs no Python.
- The **manifest**, ``analysis/programs.json``, pins each program's digests
  (the sha256 of the fingerprint's canonical form) and ``max_traces``. An
  unpinned program, a digest not pinned, a trace count above the bound, or
  a host sync raises :class:`ProgramAuditError` naming the registration
  site's ``file:line``. The manifest records the torch version and device
  type it was pinned with; digests are compared only when both match the
  run's (operator decompositions differ across versions and devices), and
  the trace bound and the host-sync hazard are enforced always.
- Re-pin: run the port's audited tests with ``DSTPU_AUDIT=write`` on the
  CPU and review the ``programs.json`` diff. ``DSTPU_AUDIT`` is the JAX
  package's variable too, so a test that also drives a JAX engine arms the
  port's audit alone through :func:`armed` instead.
- :func:`check_manifest` is the dry mode: an AST scan of the
  ``audited_program("name", ...)`` registrations against the manifest, with
  no torch import.
"""

import ast
import contextlib
import hashlib
import json
import os
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from .lint import _dotted, _norm_path, iter_python_files

_ENV = "DSTPU_AUDIT"
_VERSION = 1

#: dispatcher operations that read a device value on the host: a step
#: program that runs one waits for the device once a step (a copy from a
#: CUDA tensor to the CPU is caught separately, by its devices)
HOST_SYNC_OPS = frozenset({"aten::_local_scalar_dense", "aten::item"})
#: the operations that convert or move a tensor (promotions, copies to host)
_CONVERT_OPS = frozenset({"aten::_to_copy", "aten::copy_", "aten::to",
                          "aten::_copy_from", "aten::_copy_from_and_resize"})
_NARROW_FLOATS = frozenset({"bfloat16", "float16"})
_WIDE_FLOATS = frozenset({"float32", "float64"})


class ProgramAuditError(AssertionError):
    """A step program drifted from the pinned manifest or carries a
    hazard. An ``AssertionError`` subclass (like ``SanitizerError``), so
    the resilience layer's typed ``RuntimeError`` containment can never
    retry, quarantine or shed an audit finding."""


#: the mode :func:`armed` set, which wins over the environment
_override: Optional[str] = None


def audit_mode() -> str:
    """``""`` off | ``"check"`` enforce the manifest | ``"write"`` re-pin."""
    if _override is not None:
        return _override
    v = os.environ.get(_ENV, "").strip().lower()
    if v in ("", "0", "off", "false"):
        return ""
    return "write" if v == "write" else "check"


def default_manifest_path() -> str:
    """The packaged manifest shipped next to this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "programs.json")


def _torch_version() -> str:
    import torch
    return torch.__version__


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(x) -> Iterable:
    """Every tensor in a nest of dicts, lists and tuples."""
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _sigs(x) -> Set[str]:
    """``dtype[rK]`` of every tensor in ``x``: dims collapsed to the rank."""
    return {f"{_dtype_name(t.dtype)}[r{t.dim()}]" for t in _tensors(x)}


def _recorder_cls():
    """The recording dispatch mode, made on first use (this module imports
    no torch at import time)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        """Collects the operations, promotions and host syncs of the calls
        run inside it; can be entered more than once (a program split over
        two calls)."""

        def __init__(self):
            super().__init__()
            self.ops: Set[str] = set()
            self.syncs: Set[str] = set()
            self.promotions: Set[str] = set()
            self.devices: Set[str] = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func._schema.name
            self.ops.add(name)
            ins = list(_tensors((args, kwargs)))
            self.devices.update(t.device.type for t in ins)
            if name in HOST_SYNC_OPS:
                self.syncs.add(name)
            elif name in _CONVERT_OPS:
                dst = list(_tensors(out)) or ins[:1]
                src = ins[1:2] if name == "aten::copy_" else ins[:1]
                if src and dst:
                    s, d = src[0], dst[0]
                    if s.device.type == "cuda" and d.device.type == "cpu":
                        self.syncs.add(f"{name} cuda->cpu")
                    sn, dn = _dtype_name(s.dtype), _dtype_name(d.dtype)
                    if sn in _NARROW_FLOATS and dn in _WIDE_FLOATS:
                        self.promotions.add(f"{sn}->{dn}")
            return out

    return _Recorder


def _launch_snapshot():
    from ..ops import launch_counters
    return launch_counters.names(), launch_counters.snapshot()


def fingerprint(rec, inputs, outputs, before, after) -> Dict[str, object]:
    """Structural fingerprint of one recorded program: the canonical op
    set, the deduplicated in/out tensor signatures, the narrow -> wide float
    promotions and the kernels launched (launch counters that moved
    between ``before`` and ``after``), with the sha256 of that canonical
    form. Host syncs are reported separately (``syncs``); they perturb the
    digest through the op set."""
    names, b = before
    _, a = after
    fp: Dict[str, object] = {
        "ops": sorted(rec.ops),
        "in": sorted(_sigs(inputs)),
        "out": sorted(_sigs(outputs)),
        "promotions": sorted(rec.promotions),
        "kernels": sorted({n for i, n in enumerate(names)
                           if i < len(b) and a[i] != b[i]}),
    }
    fp["digest"] = hashlib.sha256(
        json.dumps(fp, sort_keys=True).encode()).hexdigest()[:16]
    fp["syncs"] = sorted(rec.syncs)
    return fp


# ---------------------------------------------------------------------------
# the registry + manifest gate
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Registered:
    """One ``audited_program`` site: the name keys the manifest, the site
    is the ``file:line`` every violation report carries."""
    name: str
    site: str
    declared_max: int


class ProgramRegistry:
    """Loads the manifest, checks observations against it (check mode),
    merges observations back into it (write mode), and keeps the last
    fingerprint seen of each program (``observed``)."""

    def __init__(self, manifest_path: Optional[str] = None):
        self.manifest_path = manifest_path or default_manifest_path()
        self._manifest: Optional[dict] = None
        #: name -> {digest: fingerprint} of every program observed
        self.observed: Dict[str, Dict[str, dict]] = {}

    def manifest(self) -> dict:
        if self._manifest is None:
            try:
                with open(self.manifest_path, "r", encoding="utf-8") as fh:
                    self._manifest = json.load(fh)
            except (OSError, ValueError):
                self._manifest = {"version": _VERSION, "torch": None,
                                  "device": None, "programs": {}}
        return self._manifest

    def digests_comparable(self, device: str) -> bool:
        """Whether a digest taken on ``device`` with this torch may be held
        to the manifest's."""
        man = self.manifest()
        return man.get("torch") == _torch_version() and man.get("device") == device

    # -- check mode ------------------------------------------------------
    def observe(self, reg: _Registered, fp: Dict[str, object], mode: str,
                device: str) -> None:
        self.observed.setdefault(reg.name, {})[fp["digest"]] = fp
        if mode == "write":
            self._pin(reg, fp, device)
            return
        entry = self.manifest().get("programs", {}).get(reg.name)
        if fp["syncs"] and not (entry or {}).get("allow_host_syncs"):
            raise ProgramAuditError(
                f"{reg.site}: program '{reg.name}' contains host sync(s) "
                f"{fp['syncs']} — a steady-state step program must never "
                "wait for the device; move the read out of the step or pin "
                "allow_host_syncs with a reviewed justification")
        if entry is None:
            raise ProgramAuditError(
                f"{reg.site}: program '{reg.name}' is not pinned in "
                f"{self.manifest_path} — every step program must be "
                "manifest-pinned; re-pin with DSTPU_AUDIT=write and review "
                "the diff")
        pinned = {v["digest"]: v for v in entry.get("variants", ())}
        if fp["digest"] not in pinned and self.digests_comparable(device):
            raise ProgramAuditError(
                f"{reg.site}: program '{reg.name}' drifted from the pinned "
                f"manifest — digest {fp['digest']} is not among "
                f"{sorted(pinned)} ({self._drift_summary(fp, pinned)}); "
                "if the change is intentional re-pin with DSTPU_AUDIT=write")

    @staticmethod
    def _drift_summary(fp: Dict[str, object], pinned: Dict[str, dict]) -> str:
        """Name what moved relative to the nearest pinned variant."""
        best, overlap = None, -1
        for v in pinned.values():
            n = len(set(v.get("ops", ())) & set(fp["ops"]))
            if n > overlap:
                best, overlap = v, n
        if best is None:
            return "no variants pinned"
        bits = []
        new_ops = sorted(set(fp["ops"]) - set(best.get("ops", ())))
        lost_ops = sorted(set(best.get("ops", ())) - set(fp["ops"]))
        if new_ops:
            bits.append(f"new op(s) {new_ops[:4]}")
        if lost_ops:
            bits.append(f"dropped op(s) {lost_ops[:4]}")
        for k in ("in", "out", "promotions", "kernels"):
            if fp[k] != best.get(k):
                bits.append(f"{k} {best.get(k)} -> {fp[k]}")
        return "; ".join(bits) or "op set unchanged, signatures moved"

    def check_trace_count(self, reg: _Registered, n_traces: int) -> None:
        entry = self.manifest().get("programs", {}).get(reg.name)
        bound = (entry or {}).get("max_traces", reg.declared_max)
        if n_traces > bound:
            raise ProgramAuditError(
                f"{reg.site}: program '{reg.name}' holds {n_traces} input "
                f"signatures, exceeding the pinned bound {bound} — an extra "
                "shape/dtype/flag variant entered the hot path; fix the "
                "caller or re-pin max_traces with DSTPU_AUDIT=write")

    # -- write mode ------------------------------------------------------
    def _pin(self, reg: _Registered, fp: Dict[str, object], device: str) -> None:
        """Read-merge-write the manifest: union the digest variant in,
        never lower an existing ``max_traces`` below the declared bound."""
        try:
            with open(self.manifest_path, "r", encoding="utf-8") as fh:
                man = json.load(fh)
        except (OSError, ValueError):
            man = {"version": _VERSION, "programs": {}}
        man["version"] = _VERSION
        man["torch"] = _torch_version()
        man["device"] = device
        entry = man.setdefault("programs", {}).setdefault(reg.name, {
            "max_traces": reg.declared_max, "sites": [], "variants": []})
        entry["max_traces"] = max(entry.get("max_traces", 0), reg.declared_max)
        site_file = reg.site.rsplit(":", 1)[0]
        if site_file not in entry["sites"]:
            entry["sites"] = sorted(entry["sites"] + [site_file])
        variant = {k: fp[k] for k in ("digest", "ops", "in", "out",
                                      "promotions", "kernels")}
        if all(v["digest"] != fp["digest"] for v in entry["variants"]):
            entry["variants"] = sorted(entry["variants"] + [variant],
                                       key=lambda v: v["digest"])
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(man, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, self.manifest_path)
        self._manifest = man


#: the process-wide registry of every in-tree ``audited_program`` site
GLOBAL_REGISTRY = ProgramRegistry()


@contextlib.contextmanager
def armed(mode: str = "check", registry: Optional[ProgramRegistry] = None):
    """Arm the port's audit for the block, whatever ``DSTPU_AUDIT`` says,
    and (with ``registry``) check against that registry: the way to arm the
    port alone in a process that also runs the JAX package, whose audit
    reads the same variable. ``mode=""`` disarms."""
    global _override, GLOBAL_REGISTRY
    prev = _override, GLOBAL_REGISTRY
    _override = mode
    if registry is not None:
        GLOBAL_REGISTRY = registry
    try:
        yield GLOBAL_REGISTRY
    finally:
        _override, GLOBAL_REGISTRY = prev


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _call_site() -> str:
    here = os.path.abspath(__file__)
    for frame in reversed(traceback.extract_stack()):
        if os.path.abspath(frame.filename) != here:
            return f"{_norm_path(frame.filename)}:{frame.lineno}"
    return "<unknown>:0"


def _leaf_key(x) -> Tuple:
    """A tensor or array by shape and dtype; a flag (bool, str, None) by
    value; a number by type alone, as ``jax.jit`` traces a Python scalar
    (the block index of a copy-on-write adds no program)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    if isinstance(x, (bool, str, bytes, type(None))):
        return (type(x).__name__, x)
    return (type(x).__name__,)


def _tree_key(x) -> Tuple:
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _tree_key(x[k])) for k in sorted(x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_tree_key(v) for v in x)
    return _leaf_key(x)


def _sig_key(args: tuple, kwargs: dict) -> Tuple:
    """Hashable signature of a call: its arguments' structure, tensor
    shapes and dtypes, and flags."""
    return (_tree_key(args), tuple((k, _tree_key(kwargs[k])) for k in sorted(kwargs)))


def _capturing() -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _device_of(x) -> str:
    for t in _tensors(x):
        return t.device.type
    return "cpu"


class AuditedProgram:
    """The wrapper :func:`audited_program` returns. ``variants`` names
    keyword flags that pick another set of operations inside one traced
    program of the JAX engine (the port decides them on the host, e.g. a
    step's all-greedy skip of sampled selection): each value is
    fingerprinted, but does not count as another trace."""

    def __init__(self, reg: _Registered, fn: Callable, variants: Tuple[str, ...],
                 registry: Optional[ProgramRegistry]):
        self.reg = reg
        self._fn = fn
        self._variants = variants
        self._registry = registry
        self._seen: Set[Tuple] = set()
        self._traces: Set[Tuple] = set()
        #: a split program's first half, recorded and not yet observed
        self._pending = None

    @property
    def registry(self) -> ProgramRegistry:
        return self._registry or GLOBAL_REGISTRY

    @property
    def trace_count(self) -> int:
        """Distinct input signatures seen while armed."""
        return len(self._traces)

    def _key(self, args, kwargs) -> Tuple[Tuple, Tuple]:
        key = _sig_key(args, kwargs)
        trace = _sig_key(args, {k: v for k, v in kwargs.items()
                                if k not in self._variants})
        return key, trace

    def _start(self, args, kwargs):
        """(mode, recorder or None): whether this call is audited and, for
        a signature's first eager call, the recorder to run it under."""
        mode = audit_mode()
        if not mode or _capturing():
            return "", None
        key, trace = self._key(args, kwargs)
        self._traces.add(trace)
        if key in self._seen:
            return mode, None
        self._seen.add(key)
        return mode, _recorder_cls()()

    def _run(self, rec, fn, args, kwargs):
        if rec is None:
            return fn(*args, **kwargs)
        with rec:
            return fn(*args, **kwargs)

    def _finish(self, mode, rec, inputs, out, before) -> None:
        reg = self.registry
        if rec is not None:
            fp = fingerprint(rec, inputs, out, before, _launch_snapshot())
            reg.observe(self.reg, fp, mode, _device_of(inputs))
        reg.check_trace_count(self.reg, len(self._traces))

    def __call__(self, *args, **kwargs):
        self._flush()
        mode, rec = self._start(args, kwargs)
        if not mode:
            return self._fn(*args, **kwargs)
        before = _launch_snapshot() if rec is not None else None
        out = self._run(rec, self._fn, args, kwargs)
        self._finish(mode, rec, (args, kwargs), out, before)
        return out

    # -- a program split over two calls (forward, then backward) ---------
    def begin(self, *args, **kwargs):
        """Run the program's first half (the registered function); a
        recording stays open for :meth:`end`."""
        self._flush()
        mode, rec = self._start(args, kwargs)
        if not mode:
            return self._fn(*args, **kwargs)
        before = _launch_snapshot() if rec is not None else None
        out = self._run(rec, self._fn, args, kwargs)
        self._pending = (mode, rec, [args, kwargs, out], before)
        return out

    def end(self, fn: Callable, *args, **kwargs):
        """Run the second half ``fn(*args, **kwargs)`` inside the recording
        :meth:`begin` opened, then observe the whole."""
        pending, self._pending = self._pending, None
        if pending is None:
            return fn(*args, **kwargs)
        mode, rec, parts, before = pending
        out = self._run(rec, fn, args, kwargs)
        self._finish(mode, rec, (parts[0], parts[1]), (parts[2], out), before)
        return out

    def _flush(self) -> None:
        """Observe a first half whose second half never came."""
        if self._pending is not None:
            mode, rec, parts, before = self._pending
            self._pending = None
            self._finish(mode, rec, (parts[0], parts[1]), parts[2], before)


def audited_program(name: str, fn: Callable, *, max_traces: int = 1,
                    variants: Tuple[str, ...] = (),
                    registry: Optional[ProgramRegistry] = None) -> AuditedProgram:
    """``fn`` with a manifest-pinned identity (the counterpart of
    ``audited_jit``). ``name`` keys the program in
    ``analysis/programs.json``; ``max_traces`` is the declared bound on its
    input signatures, recorded at re-pin time (the manifest's value governs
    at check time)."""
    reg = _Registered(name=name, site=_call_site(), declared_max=int(max_traces))
    return AuditedProgram(reg, fn, tuple(variants), registry)


# ---------------------------------------------------------------------------
# manifest-backed trace bounds
# ---------------------------------------------------------------------------

#: manifest program name → the engine property counting its live traces
ENGINE_TRACE_PROPS: Dict[str, str] = {
    "engine_v2.ragged": "ragged_cache_size",
    "engine_v2.fused": "fused_cache_size",
    "engine_v2.verify": "verify_cache_size",
}


def assert_trace_bounds(engine, names: Optional[Iterable[str]] = None,
                        registry: Optional[ProgramRegistry] = None
                        ) -> List[Tuple[str, int, int]]:
    """Assert every step-program counter of ``engine`` is within its
    manifest ``max_traces`` bound. Returns ``[(name, observed, bound),
    ...]`` so tests can additionally pin exact counts."""
    reg = registry or GLOBAL_REGISTRY
    programs = reg.manifest().get("programs", {})
    wanted = set(names) if names is not None else None
    out: List[Tuple[str, int, int]] = []
    for name, prop in ENGINE_TRACE_PROPS.items():
        if wanted is not None and name not in wanted:
            continue
        entry = programs.get(name)
        if entry is None:
            raise ProgramAuditError(
                f"program '{name}' is missing from {reg.manifest_path} — "
                "re-pin with DSTPU_AUDIT=write")
        observed = getattr(engine, prop)
        bound = entry["max_traces"]
        if observed > bound:
            raise ProgramAuditError(
                f"{prop} = {observed} exceeds the manifest bound {bound} "
                f"for program '{name}' (re-pin only with review)")
        out.append((name, observed, bound))
    return out


# ---------------------------------------------------------------------------
# dry mode: manifest <-> source consistency
# ---------------------------------------------------------------------------

def registered_program_names(paths: Iterable[str]) -> Dict[str, List[str]]:
    """Pure AST scan for ``audited_program("<name>", ...)`` registration
    sites under ``paths``. Returns ``{name: [file:line, ...]}``."""
    names: Dict[str, List[str]] = {}
    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and (_dotted(node.func) or "").split(".")[-1]
                    == "audited_program"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names.setdefault(node.args[0].value, []).append(
                    f"{_norm_path(path)}:{node.lineno}")
    return names


def check_manifest(paths: Iterable[str],
                   manifest_path: Optional[str] = None) -> List[str]:
    """Dry manifest check: the manifest parses and is well formed, every
    in-source ``audited_program`` registration is pinned, and no pinned
    entry is stale. Returns human-readable problems (empty = clean); never
    imports torch."""
    mpath = manifest_path or default_manifest_path()
    problems: List[str] = []
    try:
        with open(mpath, "r", encoding="utf-8") as fh:
            man = json.load(fh)
    except OSError as e:
        return [f"{mpath}: manifest unreadable ({e}) — generate it with "
                "DSTPU_AUDIT=write"]
    except ValueError as e:
        return [f"{mpath}: manifest is not valid JSON ({e})"]
    programs = man.get("programs")
    if not isinstance(programs, dict):
        return [f"{mpath}: manifest has no 'programs' table"]
    for name, entry in sorted(programs.items()):
        if not isinstance(entry.get("max_traces"), int) \
                or entry["max_traces"] < 1:
            problems.append(f"{mpath}: program '{name}' needs an integer "
                            "max_traces >= 1")
        variants = entry.get("variants")
        if not variants or not all(isinstance(v.get("digest"), str)
                                   for v in variants):
            problems.append(f"{mpath}: program '{name}' has no pinned "
                            "digest variants — re-pin with DSTPU_AUDIT=write")
    registered = registered_program_names(paths)
    for name, sites in sorted(registered.items()):
        if name not in programs:
            problems.append(f"{sites[0]}: program '{name}' is registered "
                            f"but not pinned in {mpath} — re-pin with "
                            "DSTPU_AUDIT=write")
    for name in sorted(set(programs) - set(registered)):
        problems.append(f"{mpath}: pinned program '{name}' has no "
                        "audited_program registration in the tree (stale — "
                        "re-pin to prune)")
    return problems
