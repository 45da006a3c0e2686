"""The port's DSTPU linter against the JAX package's, and its gate over the port.

- One table of source snippets, taken from the rule classes of
  ``tests/unit/test_analysis.py`` (DSTPU001/002 in their numpy forms, 003,
  005, 006, 007), goes through both linters at the same layer's path: both
  report the same ``(rule, line, qualname)`` set.
- Each torch form of a host sync, a fresh allocation, a key-material hazard
  and an open ``submit_h2d(settle=False)`` ticket is flagged by the port's
  linter, and each safe form is not.
- Suppression, the baseline, the finding cache and the CLI, as the JAX
  package's ``TestSuppression``, ``TestCLI`` and ``TestLintCache``.
- The gate: zero unsuppressed findings and no stale baseline entry over
  ``deepspeed_tpu_torch/``; a ``.item()`` planted in ``decode_step`` of a
  copy makes the CLI exit 1.
"""

import json
import os
import shutil

import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.analysis import lint_source as jax_lint_source
from deepspeed_tpu_torch.analysis import (apply_baseline, default_baseline_path,
                                          lint_paths, lint_source, load_baseline,
                                          save_baseline)
from deepspeed_tpu_torch.analysis.__main__ import main as lint_main
from deepspeed_tpu_torch.analysis.lint import _norm_path

PKG_DIR = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))

#: the layer a snippet is linted at: the port's path and the JAX package's
LAYERS = {"serve": "serve/snippet.py", "infer": "inference/v2/snippet.py",
          "resilience": "resilience/snippet.py", "models": "models/snippet.py"}


def port_path(layer):
    return f"deepspeed_tpu_torch/{LAYERS[layer]}"


def rules_of(src, layer="serve", only=None):
    return [f.rule for f in lint_source(src, port_path(layer), only)]


def triples(findings):
    return sorted((f.rule, f.line, f.qualname) for f in findings)


# ---------------------------------------------------------------------------
# the shared table: both linters, the same findings
# ---------------------------------------------------------------------------

SHARED = {
    "sync": """
import numpy as np

class Engine:
    def decode_step(self, lg, kv):
        x = np.asarray(lg)
        return x.item()
""",
    "sync_item_with_args": """
class Engine:
    def decode_step(self, d):
        return d.item(0)
""",
    "alloc": """
import numpy as np

class Engine:
    def _put_paged(self, out):
        ids = np.zeros((4, 1), np.int32)
        mask = np.ones((4,))
        return ids, mask
""",
    "alloc_cold_and_asarray": """
import numpy as np

class Engine:
    def __init__(self):
        self.buf = np.zeros((4,), np.int32)

    def decode_step(self, toks):
        dev = jnp.asarray(toks)
        return dev
""",
    "untyped_raise": """
def admit(engine, uids):
    try:
        engine.put(uids)
    except RuntimeError as e:
        if "pool exhausted" in str(e):
            raise RuntimeError("capacity")
""",
    "typed_raise": """
class QueueFullError(RuntimeError):
    pass

def admit(n):
    if n > 4:
        raise QueueFullError("backpressure")
    if n < 0:
        raise ValueError("bad n")
    raise PoolExhaustedError("full", uid=n)
""",
    "nondeterminism": """
import time, random
import numpy as np

def pick_victim(live):
    t = time.time()
    r = random.random()
    j = np.random.rand()
    for uid in set(live):
        return uid
""",
    "seeded": """
import time
import numpy as np

def pick_victim(live, clock=time.monotonic):
    rng = np.random.default_rng(0)
    t = clock()
    r = rng.random()
    for uid in sorted(set(live)):
        return uid
""",
    "key_material": """
import time, random
import numpy as np
import jax.random as jrandom

def make_keys(seed):
    k1 = jrandom.PRNGKey(int(time.time()))
    k2 = jrandom.PRNGKey(np.random.randint(0, 2**31))
    k3 = jrandom.split(jrandom.PRNGKey(hash(seed)))
    k4 = jrandom.PRNGKey(random.getrandbits(31))
    return k1, k2, k3, k4
""",
    "fold_in_chain": """
import jax.random as jrandom

def key_for(seed, position):
    base = jrandom.PRNGKey(seed)
    return jrandom.fold_in(base, position)

def keys_for(seed, n):
    return jrandom.split(jrandom.PRNGKey(seed), n)

def parse(s):
    return s.split(",")
""",
    "ticket_open_read": """
class Engine:
    def collect(self, blocks):
        t = self.transfer.submit_d2h(blocks)
        return t.value

    def collect_chained(self, blocks):
        return self.transfer.submit_d2h(blocks).value
""",
    "ticket_drained": """
class Engine:
    def collect(self, blocks):
        t = self.transfer.submit_d2h(blocks)
        self.transfer.drain_before([t])
        return t.value

    def collect_waited(self, blocks):
        t = self.transfer.submit_d2h(blocks)
        t.wait()
        return t.value

    def upload(self, blocks):
        return self.transfer.submit_h2d(blocks).value

    def start(self, blocks):
        return self.transfer.submit_d2h(blocks)
""",
    "ticket_branches": """
class Engine:
    def collect(self, blocks, eager):
        t = self.transfer.submit_d2h(blocks)
        if eager:
            self.transfer.drain_before([t])
        return t.value

    def rebind(self, blocks):
        t = self.transfer.submit_d2h(blocks)
        t = self.transfer.submit_h2d(blocks)
        return t.value
""",
    "mutate_then_raise": """
class Engine:
    def decode_step(self, req):
        self.active[req.rid] = req
        if req.bad:
            raise ValueError("bad request")

    def _put_paged(self, req):
        self.plan_deferrals += 1
        if req.bad:
            raise ValueError("bad request")
""",
    "mutate_rollback_and_branches": """
class Engine:
    def decode_step(self, req):
        self.active[req.rid] = req
        try:
            if req.bad:
                raise ValueError("bad request")
        except ValueError:
            del self.active[req.rid]
            raise

    def verify_multi(self, req):
        if req.fresh:
            self.active[req.rid] = req
        elif req.bad:
            raise ValueError("bad request")

    def decode_multi(self, req):
        if req.fresh:
            self.active[req.rid] = req
        if req.bad:
            raise ValueError("bad request")

    def setup(self, req):
        self.active[req.rid] = req
        if req.bad:
            raise ValueError("bad request")
""",
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_snippets_match_the_jax_linter(name, layer):
    src = SHARED[name]
    want = triples(jax_lint_source(src, f"deepspeed_tpu/{LAYERS[layer]}"))
    got = triples(lint_source(src, port_path(layer)))
    assert got == want


def test_shared_table_exercises_every_ported_rule():
    seen = {f.rule for src in SHARED.values() for layer in LAYERS
            for f in lint_source(src, port_path(layer))}
    assert seen == {"DSTPU001", "DSTPU002", "DSTPU003", "DSTPU005", "DSTPU006",
                    "DSTPU007"}


# ---------------------------------------------------------------------------
# the torch forms, flagged by the port's linter alone
# ---------------------------------------------------------------------------

TORCH_SYNCS = ["x.item()", "x.tolist()", "x.cpu()", "x.numpy()", 'x.to("cpu")',
               'x.to(device="cpu")', 'x.to(torch.device("cpu"))',
               "torch.cuda.synchronize()", "ev.synchronize()",
               "torch.cuda.current_stream().synchronize()", "np.asarray(x)"]


@pytest.mark.parametrize("expr", TORCH_SYNCS)
def test_torch_host_syncs_are_flagged_in_hot_functions(expr):
    src = f"""
import numpy as np
import torch

class Engine:
    def decode_step(self, x, ev):
        return {expr}

    def warmup(self, x, ev):
        return {expr}
"""
    found = lint_source(src, port_path("infer"))
    assert [(f.rule, f.qualname) for f in found] == [("DSTPU001", "Engine.decode_step")]
    assert rules_of(src, "models") == []  # out of the hot scope


@pytest.mark.parametrize("expr", ['x.to("cuda")', "x.to(torch.float32)", "x.item(0)",
                                  "x.cpu(memory_format=fmt)", "torch.as_tensor(x)"])
def test_safe_torch_forms_are_not_syncs(expr):
    src = f"""
import torch

class Engine:
    def decode_step(self, x, fmt):
        return {expr}
"""
    assert rules_of(src, "infer") == []


TORCH_ALLOCS = ["torch.zeros(4)", "torch.ones(4)", "torch.empty(4)", "torch.full((4,), 1)",
                "torch.tensor([1, 2])", "torch.arange(4)", "torch.zeros_like(x)",
                "torch.ones_like(x)", "torch.empty_like(x)", "torch.full_like(x, 1)",
                "np.array([1])", "np.full_like(x, 1)"]


@pytest.mark.parametrize("expr", TORCH_ALLOCS)
def test_torch_allocations_are_flagged_in_hot_functions(expr):
    src = f"""
import numpy as np
import torch

class Engine:
    def _put_paged(self, x):
        return {expr}

    def __init__(self, x):
        self.buf = {expr}
"""
    found = lint_source(src, port_path("serve"))
    assert [(f.rule, f.qualname) for f in found] == [("DSTPU002", "Engine._put_paged")]


KEY_HAZARDS = ["prng.PRNGKey(int(time.time()))", "prng.split(prng.PRNGKey(os.getpid()))",
               "prng.fold_in(key, time.time_ns())",
               "torch.Generator().manual_seed(int(time.time()))",
               "torch.manual_seed(torch.seed())", "gen.manual_seed(hash(x))"]


@pytest.mark.parametrize("expr", KEY_HAZARDS)
def test_torch_key_material_hazards_are_flagged(expr):
    src = f"""
import os, time
import torch
from deepspeed_tpu_torch.utils import prng

def make_key(key, gen, x):
    return {expr}
"""
    assert "DSTPU005" in rules_of(src, "infer")
    assert rules_of(src, "models") == []  # out of the key-material scope


@pytest.mark.parametrize("expr", ["prng.PRNGKey(seed)", "prng.fold_in(prng.PRNGKey(seed), pos)",
                                  "prng.split(prng.PRNGKey(0), 4)",
                                  "torch.Generator().manual_seed(seed)",
                                  "torch.rand(4, generator=gen)"])
def test_counter_based_keys_and_seeded_generators_are_fine(expr):
    src = f"""
import torch
from deepspeed_tpu_torch.utils import prng

def make_key(seed, pos, gen):
    return {expr}
"""
    assert rules_of(src, "serve") == []


def test_torch_global_rng_in_decision_logic_is_flagged():
    src = """
import torch

def pick_victim(live):
    return live[int(torch.randint(0, len(live), ()))]
"""
    assert rules_of(src, "serve") == ["DSTPU005"]
    assert rules_of(src, "infer") == []  # decisions live in serve/resilience


def test_open_h2d_ticket_read_is_flagged():
    src = """
class Engine:
    def upload(self, buf):
        t = self.transfer.submit_h2d(buf, settle=False)
        return t.value

    def upload_chained(self, buf, settle):
        return self.transfer.submit_h2d(buf, settle=settle).value

    def upload_drained(self, buf):
        t = self.transfer.submit_h2d(buf, settle=False)
        self.transfer.drain_before([t])
        return t.value

    def upload_settled(self, buf):
        return self.transfer.submit_h2d(buf, settle=True).value
"""
    found = lint_source(src, port_path("infer"))
    assert [(f.rule, f.qualname) for f in found] == [
        ("DSTPU006", "Engine.upload"), ("DSTPU006", "Engine.upload_chained")]
    # the JAX linter exempts every submit_h2d: its tickets settle at submit
    assert jax_lint_source(src, "deepspeed_tpu/inference/v2/snippet.py") == []


def test_qualified_hot_names_apply_to_their_class_only():
    src = """
class _StepProgram:
    def run(self, x):
        return x.item()

class TrainingSupervisor:
    def run(self, x):
        return x.item()
"""
    found = lint_source(src, port_path("infer"))
    assert [(f.rule, f.qualname) for f in found] == [("DSTPU001", "_StepProgram.run")]


# ---------------------------------------------------------------------------
# suppression: inline pragma + baseline
# ---------------------------------------------------------------------------

SUPPRESSIBLE = """
import numpy as np

class Engine:
    def decode_step(self, lg):
        return lg.cpu().numpy()
"""


class TestSuppression:
    def test_inline_pragma(self):
        tagged = SUPPRESSIBLE.replace(
            "lg.cpu().numpy()", "lg.cpu().numpy()  # dstpu-lint: ignore[DSTPU001]")
        assert [f for f in lint_source(tagged, port_path("serve"))
                if not f.suppressed_inline] == []
        bare = SUPPRESSIBLE.replace("lg.cpu().numpy()", "lg.cpu().numpy()  # dstpu-lint: ignore")
        assert all(f.suppressed_inline for f in lint_source(bare, port_path("serve")))
        wrong = SUPPRESSIBLE.replace(
            "lg.cpu().numpy()", "lg.cpu().numpy()  # dstpu-lint: ignore[DSTPU005]")
        assert [f.rule for f in lint_source(wrong, port_path("serve"))
                if not f.suppressed_inline] == ["DSTPU001", "DSTPU001"]

    def test_baseline_round_trip(self, tmp_path):
        src_file = tmp_path / "deepspeed_tpu_torch" / "serve" / "mod.py"
        src_file.parent.mkdir(parents=True)
        src_file.write_text(SUPPRESSIBLE)
        findings = lint_paths([str(tmp_path)])
        assert [f.rule for f in findings] == ["DSTPU001", "DSTPU001"]
        bl = tmp_path / "baseline.txt"
        assert save_baseline(str(bl), findings) == 1  # one key: same line
        unsup, stale = apply_baseline(findings, load_baseline(str(bl)))
        assert unsup == [] and stale == set()
        # keys survive line drift...
        src_file.write_text("# a new leading comment\n" + SUPPRESSIBLE)
        unsup, stale = apply_baseline(lint_paths([str(tmp_path)]), load_baseline(str(bl)))
        assert unsup == [] and stale == set()
        # ...but not edits to the flagged line itself
        src_file.write_text(SUPPRESSIBLE.replace("lg.cpu()", "lg[0].cpu()"))
        unsup, stale = apply_baseline(lint_paths([str(tmp_path)]), load_baseline(str(bl)))
        assert [f.rule for f in unsup] == ["DSTPU001", "DSTPU001"] and len(stale) == 1

    def test_missing_baseline_is_empty_and_malformed_raises(self, tmp_path):
        assert load_baseline(str(tmp_path / "nope.txt")) == set()
        bad = tmp_path / "bad.txt"
        bad.write_text("DSTPU001\tonly-two-fields\n")
        with pytest.raises(ValueError, match="malformed"):
            load_baseline(str(bad))

    def test_norm_path_is_location_independent(self):
        assert _norm_path("/a/b/deepspeed_tpu_torch/serve/x.py") == \
            _norm_path("deepspeed_tpu_torch/serve/x.py") == "deepspeed_tpu_torch/serve/x.py"
        assert _norm_path("/tmp/loose.py") == "loose.py"

    def test_packaged_baseline_entries_carry_reasons(self):
        with open(default_baseline_path()) as fh:
            lines = fh.read().splitlines()
        entries = [i for i, ln in enumerate(lines) if ln and not ln.startswith("#")]
        assert entries
        for i in entries:
            assert lines[i].split("\t")[1].startswith("deepspeed_tpu_torch/")
            assert lines[i - 1].startswith("# ") and len(lines[i - 1]) > 10, lines[i]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

class TestCLI:
    def _tree(self, tmp_path, src=SUPPRESSIBLE):
        f = tmp_path / "deepspeed_tpu_torch" / "serve" / "mod.py"
        f.parent.mkdir(parents=True)
        f.write_text(src)
        return tmp_path

    def test_exit_codes_and_baseline(self, tmp_path, capsys):
        root = self._tree(tmp_path)
        assert lint_main([str(root), "--baseline", "none"]) == 1
        out = capsys.readouterr().out
        assert "DSTPU001" in out and "hint:" in out and "mod.py" in out
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert lint_main([str(clean), "--baseline", "none"]) == 0
        assert lint_main([str(tmp_path / "missing")]) == 2
        assert lint_main([str(root), "--rules", "DSTPU004"]) == 2  # not ported
        bl = tmp_path / "bl.txt"
        assert lint_main([str(root), "--baseline", str(bl), "--write-baseline"]) == 0
        assert lint_main([str(root), "--baseline", str(bl)]) == 0
        capsys.readouterr()

    def test_rules_filter_and_json(self, tmp_path, capsys):
        root = self._tree(tmp_path)
        assert lint_main([str(root), "--baseline", "none", "--rules", "DSTPU002"]) == 0
        capsys.readouterr()
        assert lint_main([str(root), "--baseline", "none", "--json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert out["summary"]["unsuppressed"] == 2
        assert {f["rule"] for f in out["findings"]} == {"DSTPU001"}

    def test_list_rules_names_the_missing_retrace_rule(self, capsys):
        assert lint_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rid in ("DSTPU001", "DSTPU002", "DSTPU003", "DSTPU005", "DSTPU006", "DSTPU007"):
            assert rid in out
        assert "DSTPU004  not ported" in out

    def test_syntax_error_fails_loudly(self, tmp_path, capsys):
        f = tmp_path / "broken.py"
        f.write_text("def f(:\n")
        assert lint_main([str(f), "--baseline", "none"]) == 1
        assert "DSTPU000" in capsys.readouterr().out

    def test_check_programs_dry_mode(self, tmp_path, capsys):
        src = tmp_path / "deepspeed_tpu_torch" / "serve" / "mod.py"
        src.parent.mkdir(parents=True)
        src.write_text(
            "from deepspeed_tpu_torch.analysis import audited_program\n"
            "def build(step):\n"
            "    return audited_program('serve.step', step, max_traces=2)\n")
        man = tmp_path / "programs.json"
        man.write_text(json.dumps({"version": 1, "torch": "0.0", "device": "cpu", "programs": {
            "serve.step": {"max_traces": 2, "sites": [], "variants": [{"digest": "abc"}]}}}))
        argv = [str(tmp_path), "--check-programs", "--programs", str(man)]
        assert lint_main(argv) == 0
        assert "consistent" in capsys.readouterr().out
        src.write_text(src.read_text().replace("serve.step", "serve.other"))
        assert lint_main(argv) == 1
        out = capsys.readouterr().out
        assert "serve.other" in out and "mod.py:3" in out
        assert "serve.step" in out and "stale" in out
        man.write_text("{not json")
        assert lint_main(argv) == 1
        assert "not valid JSON" in capsys.readouterr().out


class TestLintCache:
    def _tree(self, tmp_path):
        f = tmp_path / "deepspeed_tpu_torch" / "serve" / "mod.py"
        f.parent.mkdir(parents=True)
        f.write_text(SUPPRESSIBLE)
        (tmp_path / "deepspeed_tpu_torch" / "serve" / "clean.py").write_text("x = 1\n")
        return tmp_path, f

    def test_hit_on_unchanged_miss_on_edit_and_rule_change(self, tmp_path):
        from deepspeed_tpu_torch.analysis.cache import LintCache, lint_paths_cached

        root, f = self._tree(tmp_path)
        cpath = str(tmp_path / "cache.json")
        cold = LintCache(cpath)
        found1 = lint_paths_cached([str(root)], None, cold)
        assert cold.hits == 0 and cold.misses == 2
        warm = LintCache(cpath)
        found2 = lint_paths_cached([str(root)], None, warm)
        assert warm.hits == 2 and warm.misses == 0
        assert ([(x.rule, x.norm_path, x.line) for x in found1]
                == [(x.rule, x.norm_path, x.line) for x in found2])
        f.write_text(SUPPRESSIBLE + "\n# touched\n")
        os.utime(f, ns=(1, 1))
        third = LintCache(cpath)
        lint_paths_cached([str(root)], None, third)
        assert third.hits == 1 and third.misses == 1
        narrow = LintCache(cpath)
        assert lint_paths_cached([str(root)], ["DSTPU002"], narrow) == []
        assert narrow.misses == 2

    def test_corrupt_cache_is_cold_not_fatal(self, tmp_path):
        from deepspeed_tpu_torch.analysis.cache import LintCache, lint_paths_cached

        root, _ = self._tree(tmp_path)
        cpath = tmp_path / "cache.json"
        cpath.write_text("{not json")
        cache = LintCache(str(cpath))
        assert len(lint_paths_cached([str(root)], None, cache)) >= 1
        assert cache.misses == 2

    def test_data_file_edit_invalidates(self, tmp_path, monkeypatch):
        import deepspeed_tpu_torch.analysis.cache as cache_mod
        from deepspeed_tpu_torch.analysis.cache import LintCache, lint_paths_cached

        pkg = tmp_path / "fakepkg"
        pkg.mkdir()
        (pkg / "lint.py").write_text("# linter source\n")
        bl = pkg / "baseline.txt"
        bl.write_text("DSTPU001\tdeepspeed_tpu_torch/serve/mod.py\tx\n")
        monkeypatch.setattr(cache_mod, "__file__", str(pkg / "cache.py"))
        self._tree(tmp_path)
        root = tmp_path / "deepspeed_tpu_torch"
        cpath = str(tmp_path / "cache.json")
        lint_paths_cached([str(root)], None, LintCache(cpath))
        warm = LintCache(cpath)
        lint_paths_cached([str(root)], None, warm)
        assert warm.hits == 2
        bl.write_text("DSTPU001\tdeepspeed_tpu_torch/serve/mod.py\ty\n")
        os.utime(bl, ns=(1, 1))
        cold = LintCache(cpath)
        lint_paths_cached([str(root)], None, cold)
        assert cold.hits == 0 and cold.misses == 2

    def test_cli_cache_flag(self, tmp_path, capsys):
        root, _ = self._tree(tmp_path)
        cpath = str(tmp_path / "cache.json")
        argv = [str(root), "--baseline", "none", f"--cache={cpath}"]
        assert lint_main(argv) == 1
        assert lint_main(argv) == 1
        assert "cache 2 hits" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the gate: the port's own tree is clean
# ---------------------------------------------------------------------------

def test_port_tree_has_zero_unsuppressed_findings():
    findings = lint_paths([PKG_DIR])
    unsup, stale = apply_baseline(findings, load_baseline(default_baseline_path()))
    assert not unsup, "unsuppressed lint findings:\n" + "\n".join(f.render() for f in unsup)
    assert not stale, f"stale baseline entries (prune them): {stale}"


def test_planted_sync_in_a_copy_fails_the_cli(tmp_path, capsys):
    assert lint_main([PKG_DIR, "-q"]) == 0
    copy = tmp_path / "deepspeed_tpu_torch"
    shutil.copytree(PKG_DIR, copy, ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    eng = copy / "inference" / "v2" / "engine_v2.py"
    src = eng.read_text()
    head = "    def decode_step(self,"
    i = src.index(head)
    j = src.index('"""', src.index('"""', i) + 3) + 3  # past its docstring
    eng.write_text(src[:j] + "\n        self._planted = self.kv[0].sum().item()" + src[j:])
    capsys.readouterr()
    assert lint_main([str(copy)]) == 1
    out = capsys.readouterr().out
    assert "DSTPU001" in out and "InferenceEngineV2.decode_step" in out
