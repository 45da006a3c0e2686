"""Rule catalog for the DSTPU hazard linter over the port (counterpart of
``deepspeed_tpu/analysis/rules.py``).

The rule IDs, titles, hints and path scopes are the JAX package's, so a
finding reads the same in both trees. What differs is what a hazard looks
like in PyTorch: the host syncs of DSTPU001 are ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize`` and an
event's or stream's ``synchronize``, beside ``np.asarray``; the fresh
allocations of DSTPU002 are the ``torch.zeros/ones/empty/full/tensor/arange``
family beside ``np.*``; DSTPU005's key material is the port's threefry
(``utils/prng.py``: ``PRNGKey``, ``split``, ``fold_in``) and a
``torch.Generator``'s ``manual_seed``. DSTPU004 (retrace hazards in
``jax.jit``-traced code) has no counterpart: the port traces nothing, and an
extra step program is caught by the program audit's trace bound
(``program_audit.py``) instead.
"""

from dataclasses import dataclass
from typing import Dict, FrozenSet, Tuple


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    #: one-line remediation appended to every finding of this rule
    hint: str
    #: directory parts a file must contain for the rule to apply;
    #: empty = whole tree
    scope: Tuple[str, ...] = ()


#: functions whose bodies are the steady-state serving and training hot
#: paths: one iteration is one generated token or one optimizer step. The
#: JAX package's set (``rules.py:38-96``), every name of which the port
#: keeps, and below it the port's own names for the same work. A dotted
#: ``Class.method`` entry makes only that class's method hot.
HOT_FUNCTIONS: FrozenSet[str] = frozenset({
    "decode_step", "decode_multi", "verify_multi", "_put_paged",
    "_decode_once", "_absorb", "_absorb_multi", "_absorb_speculation",
    "step", "_collect_drafts", "propose",
    "_emit_token", "commit", "record",
    # pipelined dispatch: ``fetch`` carries the round's one designed
    # materialization (suppressed at the site)
    "_decode_sync", "decode_dispatch", "commit_step", "fetch",
    "step_dispatch", "step_absorb", "_pipeline_dispatch_stage",
    "_pipeline_absorb_stage", "_drain_inflight", "_engine_commit",
    # the training micro-step loop: one iteration is one optimizer step
    "train_batch", "step_fn", "backward", "_fused_micro_step",
    "_multi_exec_step",
    # the engine pool's per-submission placement and its prefix probes
    "place", "probe", "prefix_probe",
    # KV-tier data movement: demotion and swap-out ride the decode loop;
    # promotion and swap-in carry the tier's one designed sync each
    "_demote_block", "_scatter_blocks", "_drain_promotions",
    "swap_out", "swap_in", "_swap_in_readmit", "_preempt", "_swap_wins",
    # the disaggregated prefill/decode handoff
    "export_swap", "import_swap", "export_ready", "detach_with_kv",
    "_dispatch_handoffs", "_handoff",
    # ZeRO offload and stage-3 residency
    "adam_step", "_step_offload",
    "_ensure_zero3_params", "_z3_release_and_prefetch",
    # the TransferEngine: every offload and tier byte rides these
    "submit_d2h", "submit_h2d", "drain_before", "drain_oldest",
    "drain_all", "acquire_staging", "release_staging",
    "release_staging_by_key", "put_tree", "get_tree",
    "cancel_ticket", "cancel_all", "_settle",
    "_spill_block", "_load_block", "_drop_block", "_materialize",
    "_moments",
    # -- the port's names for the same work --------------------------
    # the staged inputs and the launch or graph replay of a step program
    # (stand for the dispatch of the JAX engine's compiled programs)
    "_StepProgram.stage", "_StepProgram.run",
    # the paged step, the fused/verify step and the slot steps around
    # their programs (stand for the bodies of ``_get_ragged``,
    # ``_get_fused``/``_get_verify``, ``_get_decode``, ``_get_prefill``)
    "_ragged", "_run_multi", "_slot_decode", "_slot_prefill",
    # the optimizer update after the micro-steps (stands for ``step_fn``)
    "_apply_update",
})

#: where the hot-path rules (001/002) apply
HOT_SCOPE = ("serve", "inference", "resilience", "runtime")
#: where the typed-error rule (003) applies
TAXONOMY_SCOPE = ("serve", "inference", "resilience")
#: where the determinism rule (005) applies: scheduling and containment
#: decisions must replay
DECISION_SCOPE = ("serve", "resilience")
#: where the transfer-ticket rule (006) applies
TRANSFER_SCOPE = ("serve", "inference", "resilience", "runtime")
#: where the exception-safety rule (007) applies
MUTATE_RAISE_SCOPE = ("serve", "inference")

#: host-sync methods flagged by DSTPU001 when called with no arguments:
#: each waits for the device (or, for ``numpy``, hands out a host view of
#: what a ``.cpu()`` just waited for)
SYNC_ATTRS_NOARG: FrozenSet[str] = frozenset({
    "item", "tolist", "cpu", "numpy",
})
#: host-sync methods flagged with any arguments: ``torch.cuda.Event`` and
#: ``Stream.synchronize``, and the JAX spellings, kept so that a snippet
#: reads the same under both linters
SYNC_ATTRS: FrozenSet[str] = frozenset({
    "synchronize", "block_until_ready", "device_get",
})
SYNC_DOTTED: FrozenSet[str] = frozenset({
    "np.asarray", "numpy.asarray", "torch.cuda.synchronize",
    "jax.device_get", "jax.block_until_ready",
})

#: fresh-array constructors flagged by DSTPU002 in a hot function, by
#: module root. ``asarray`` / ``as_tensor`` / ``from_numpy`` are absent:
#: wrapping an existing buffer for dispatch is the transfer itself.
ALLOC_NAMES_BY_ROOT: Dict[str, FrozenSet[str]] = {
    root: frozenset({"zeros", "ones", "empty", "full", "arange",
                     "zeros_like", "ones_like", "empty_like", "full_like"})
    | extra
    for root, extra in (("np", frozenset({"array"})),
                        ("numpy", frozenset({"array"})),
                        ("torch", frozenset({"tensor"})))
}

#: exception types whose raw ``raise`` DSTPU003 flags in taxonomy scope
UNTYPED_RAISES: FrozenSet[str] = frozenset({
    "RuntimeError", "Exception", "BaseException",
})

#: seeded/injectable RNG constructors exempt from DSTPU005 under
#: ``np.random.`` / ``numpy.random.``
SEEDED_RNG: FrozenSet[str] = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "Philox",
})
#: torch's global-state RNG entry points: a draw from them in decision
#: logic does not replay unless a ``generator=`` is passed
TORCH_GLOBAL_RNG: FrozenSet[str] = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.multinomial", "torch.bernoulli", "torch.normal",
    "torch.seed", "torch.random.seed",
})

#: DSTPU005's key-material check: in the serving and inference layers,
#: threefry key material (``PRNGKey``/``split``/``fold_in``) and a
#: generator's ``manual_seed`` must be replay-derivable: a constant, a
#: carried seed, or a counter-based ``fold_in(PRNGKey(seed), position)``
#: chain; only a nondeterministic call in the arguments flags
RNG_KEY_SCOPE = ("serve", "inference", "resilience")
#: module spellings a flagged ``PRNGKey``/``split`` call may hang off: the
#: port's ``utils/prng.py`` under its import names, and the JAX spellings
RNG_KEY_BASES: FrozenSet[str] = frozenset({
    "prng", "utils.prng", "jax.random", "jrandom", "jr", "random",
})
#: nondeterministic key-material sources: any of these calls in the
#: argument expression of a key or seed call is a finding
KEY_HAZARD_CALLS: FrozenSet[str] = frozenset({
    "time.time", "time.time_ns", "time.perf_counter", "time.monotonic",
    "os.urandom", "os.getrandom", "os.getpid",
    "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.randbits", "secrets.randbelow",
    "id", "hash", "torch.seed", "torch.random.seed", "torch.initial_seed",
})
#: stdlib-``random`` leaves treated as hazardous key material
STDLIB_RANDOM_LEAVES: FrozenSet[str] = frozenset({
    "random", "randint", "randrange", "getrandbits", "randbytes",
    "uniform", "choice", "gauss", "betavariate", "expovariate",
})

#: calls that settle outstanding transfer tickets (DSTPU006)
DRAIN_CALLS: FrozenSet[str] = frozenset({
    "drain_before", "drain_all", "drain_oldest", "wait", "cancel",
    "cancel_all", "cancel_ticket",
})

RULES: Dict[str, Rule] = {r.id: r for r in (
    Rule(
        id="DSTPU001",
        title="host-device sync in a serving hot path",
        hint="batch the transfer (one device-to-host copy per step) or move "
             "it off the per-token loop; suppress only the step's single "
             "designed transfer",
        scope=HOT_SCOPE,
    ),
    Rule(
        id="DSTPU002",
        title="fresh host allocation in a steady-state step function",
        hint="reuse a per-shape preallocated buffer written in place (see "
             "InferenceEngineV2._program) instead of allocating per dispatch",
        scope=HOT_SCOPE,
    ),
    Rule(
        id="DSTPU003",
        title="untyped raise / string-matched exception dispatch",
        hint="raise a type from deepspeed_tpu_torch.resilience.errors (or a "
             "named subclass) and dispatch on isinstance, never on str(e)",
        scope=TAXONOMY_SCOPE,
    ),
    Rule(
        id="DSTPU006",
        title="open TransferTicket read without a dominating drain",
        hint="settle the ticket first — te.drain_before([deps])/"
             "ticket.wait() — or move the .value read to the consumer "
             "that drains; submit_h2d tickets settle at submit unless "
             "submitted with settle=False",
        scope=TRANSFER_SCOPE,
    ),
    Rule(
        id="DSTPU007",
        title="state write precedes a raise in a serving hot path",
        hint="validate every precondition before the first self.* write, "
             "or roll the writes back before re-raising — a mid-mutation "
             "raise leaves the engine half-mutated",
        scope=MUTATE_RAISE_SCOPE,
    ),
    Rule(
        id="DSTPU005",
        title="nondeterminism in scheduler/resilience decision logic",
        hint="use the injectable clock (time.monotonic default), a seeded "
             "np.random.default_rng or torch.Generator, ordered containers, "
             "and counter-based threefry keys (fold_in(PRNGKey(seed), "
             "position)) — decisions and sampled tokens must replay "
             "bit-for-bit",
        scope=DECISION_SCOPE,
    ),
)}

ALL_RULE_IDS = tuple(sorted(RULES))
