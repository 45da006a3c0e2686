"""The port's checked KV cache against the JAX package's, on the CPU.

- The seeded bugs of ``tests/unit/test_sanitizer.py``'s
  ``TestCheckedCacheSeededBugs``, each planted in both packages' checked
  caches: the same operation raises ``SanitizerError`` in both, with the same
  message prefix (the clean lifecycle raises in neither).
- The port's engine builds the checked cache only when ``DSTPU_SANITIZE`` is
  armed, and builds it again on ``rebuild()``.
- A clean scheduler workload, run checked and unchecked, gives bitwise-equal
  streams and equal counters in the port, and the JAX scheduler's checked
  run gives the same streams and counters.
"""

import pytest

import deepspeed_tpu.analysis.sanitizer as jsan
import deepspeed_tpu.inference.v2.ragged_manager as jrm
import deepspeed_tpu_torch.analysis.sanitizer as tsan
import deepspeed_tpu_torch.inference.v2.ragged_manager as trm
from tests.test_torch_scheduler import (_preempt_script, ab_script, assert_same, engine,
                                        models, run)

PKG = {"jax": (jsan, jrm), "torch": (tsan, trm)}
assert models  # the module-scoped weights fixture, shared with the scheduler's tests


def _checked(san, num_blocks=9, block_size=4, max_per_seq=8, prefix=True):
    return san.checked_cache_cls()(num_blocks, block_size, max_per_seq, prefix_cache=prefix)


def _two_sharing_descs(rm, cache):
    """d1 registered with 2 full blocks; d2 prefix-hits both."""
    bs = cache.block_size
    toks = list(range(2 * bs))
    d1 = rm.SequenceDescriptor(uid=1, slot=0)
    cache.ensure(d1, len(toks))
    d1.history.extend(toks)
    d1.seen_tokens = len(toks)
    cache.register(d1)
    d2 = rm.SequenceDescriptor(uid=2, slot=1)
    assert cache.lookup(d2, toks + [99]) == 2 * bs and d2.blocks == d1.blocks
    return d1, d2


# each scenario plants one bug and returns the operation that must raise
def _clean(san, rm, mp):
    cache = _checked(san)
    d1, d2 = _two_sharing_descs(rm, cache)

    def op():
        cache.ensure(d2, 9)
        cache.copy_on_write(d2, 1)
        cache.rollback(d2, 4)
        cache.free(d2)
        cache.free(d1)
        cache.flush_cache()
        cache.verify("final")
    return op


def _refcount_leak(san, rm, mp):
    cache = _checked(san)
    d1, _ = _two_sharing_descs(rm, cache)
    cache._incref(d1.blocks[0])
    return lambda: cache.ensure(rm.SequenceDescriptor(uid=3, slot=2), 4)


def _double_free(san, rm, mp):
    cache = _checked(san)
    d = rm.SequenceDescriptor(uid=1, slot=0)
    cache.ensure(d, 8)
    stale = list(d.blocks)
    cache.free(d)
    d.blocks = stale
    return lambda: cache.free(d)


def _use_after_free(san, rm, mp):
    cache = _checked(san)
    d = rm.SequenceDescriptor(uid=1, slot=0)
    cache.ensure(d, 8)
    cache._decref(d.blocks[-1])
    return lambda: cache.verify("uaf-check")


def _rollback_over_free(san, rm, mp):
    cache = _checked(san)
    d = rm.SequenceDescriptor(uid=1, slot=0)
    cache.ensure(d, 16)

    def buggy_rollback(self, desc, n_tokens):
        keep = self.blocks_needed(n_tokens) - 1  # off-by-one over-free
        freed = 0
        while len(desc.blocks) > keep:
            self._decref(desc.blocks.pop())
            freed += 1
        return freed

    mp.setattr(rm.BlockedKVCache, "rollback", buggy_rollback)
    return lambda: cache.rollback(d, 8)


def _cow_exclusivity(san, rm, mp):
    cache = _checked(san)
    _, d2 = _two_sharing_descs(rm, cache)
    mp.setattr(rm.BlockedKVCache, "copy_on_write", lambda self, desc, j: (desc.blocks[j],) * 2)
    return lambda: cache.copy_on_write(d2, 0)


def _full_prompt_lookup(san, rm, mp):
    cache = _checked(san)
    d1, _ = _two_sharing_descs(rm, cache)

    def buggy_lookup(self, desc, tokens):
        for b in d1.blocks:
            self._incref(b)
        desc.blocks = list(d1.blocks)
        desc.n_indexed = len(desc.blocks)
        return len(tokens)

    mp.setattr(rm.BlockedKVCache, "lookup", buggy_lookup)
    d3 = rm.SequenceDescriptor(uid=3, slot=2)
    return lambda: cache.lookup(d3, list(range(2 * cache.block_size)))


def _register_during_speculation(san, rm, mp):
    cache = _checked(san)
    d = rm.SequenceDescriptor(uid=1, slot=0)
    cache.ensure(d, 12)
    d.history.extend(range(12))
    d.seen_tokens = 12
    d.uncommitted = 4  # the last fused step's positions, not yet committed
    return lambda: cache.register(d)


SEEDED = {
    "clean": (_clean, None),
    "refcount_leak": (_refcount_leak, "invariant broken"),
    "double_free": (_double_free, "double free"),
    "use_after_free": (_use_after_free, "use-after-free"),
    "rollback_over_free": (_rollback_over_free, "rollback exactness"),
    "cow_exclusivity": (_cow_exclusivity, "COW"),
    "full_prompt_lookup": (_full_prompt_lookup, "final prompt token"),
    "register_during_speculation": (_register_during_speculation,
                                    "register during speculation"),
}


def _outcome(kind, scenario, monkeypatch):
    san, rm = PKG[kind]
    op = scenario(san, rm, monkeypatch)
    try:
        op()
    except san.SanitizerError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_bug_raises_at_the_same_operation_in_both(name, monkeypatch):
    scenario, match = SEEDED[name]
    want = _outcome("jax", scenario, monkeypatch)
    monkeypatch.undo()
    got = _outcome("torch", scenario, monkeypatch)
    if match is None:
        assert want is None and got is None
        return
    assert want is not None and match in want
    assert got is not None and match in got
    # the same message up to the detail after its first colon
    assert got.split(":")[0] == want.split(":")[0]
    if name != "refcount_leak":  # the wrapped invariant's own words may differ
        assert got == want


def test_sanitizer_error_is_an_assertion_error():
    assert issubclass(tsan.SanitizerError, AssertionError)
    assert type(_checked(tsan)).__name__ == "CheckedBlockedKVCache"


def test_engine_builds_checked_cache_only_when_armed(models, monkeypatch):
    checked = tsan.checked_cache_cls()
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    eng = engine("torch", models)
    assert isinstance(eng.block_mgr, checked)
    eng.put([1], [[1, 2, 3, 4, 5]], greedy=True)
    assert list(eng.block_mgr._descs()) == list(eng.state.seqs.values())
    old = eng.block_mgr
    eng.rebuild()
    assert isinstance(eng.block_mgr, checked) and eng.block_mgr is not old
    assert list(eng.block_mgr._descs()) == []  # the rebuilt engine's state
    monkeypatch.setenv("DSTPU_SANITIZE", "0")
    eng.rebuild()
    assert type(eng.block_mgr) is trm.BlockedKVCache
    plain = engine("torch", models)
    assert type(plain.block_mgr) is trm.BlockedKVCache
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    plain.rebuild()
    assert isinstance(plain.block_mgr, checked)


def test_checked_engine_catches_a_planted_double_free(models, monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    eng = engine("torch", models)
    eng.put([1], [list(range(20))], greedy=True)
    d = eng.state.seqs[1]
    stale = list(d.blocks)
    eng.flush(1)
    d.blocks = stale
    with pytest.raises(tsan.SanitizerError, match="double free"):
        eng.block_mgr.free(d)


WORKLOADS = {"ab": (ab_script, {}),
             "preempt_sampled": (_preempt_script(True), dict(num_blocks=7))}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_clean_workload_checked_is_bitwise_unchecked(models, monkeypatch, name):
    script, eng_kw = WORKLOADS[name]
    runs = {}
    for armed in ("0", "1"):
        monkeypatch.setenv("DSTPU_SANITIZE", armed)
        reqs, counters, _, eng = run("torch", models, script, eng_kw=eng_kw)
        assert isinstance(eng.block_mgr, tsan.checked_cache_cls()) == (armed == "1")
        runs[armed] = ([r.tokens for r in reqs], counters)
    assert runs["1"] == runs["0"]
    # and the JAX scheduler's checked run agrees with the port's
    assert_same(models, run("jax", models, script, eng_kw=eng_kw),
                run("torch", models, script, eng_kw=eng_kw))
