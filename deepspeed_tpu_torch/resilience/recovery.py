"""Engine-loss recovery: request journal + rebuild policy (docs/RESILIENCE.md).

A copy of ``deepspeed_tpu/resilience/recovery.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

At pod scale whole-engine death — device reset, XLA abort, wedged dispatch —
is routine (arXiv:2011.03641). PR 3's containment handles *per-request*
faults; this module makes the engine itself a replaceable component. Two
pieces, both host-side and engine-agnostic:

:class:`RequestJournal`
    A write-ahead record per live request holding exactly the state the
    prefix-cache replay path already proves sufficient to resume bitwise
    under greedy decoding (docs/PREFIX_CACHING.md): the prompt, the
    committed generated tokens, and the sampling-irrelevant admission
    metadata (priority/deadline/arrival/eos). Written at submission,
    synced at each commit point (one emitted token), dropped at terminal
    resolution. The journal never references device state — it survives
    the engine by construction.

:class:`RecoveryPolicy`
    The budget and audit trail for hot rebuilds. Rebuilds are admitted
    until ``max_consecutive_rebuilds`` engine losses occur with no proven
    healthy dispatch in between — an engine that dies on every incarnation
    is the supervisor's problem, exactly like an unbounded transient storm
    is for retry.

The scheduler composes these (``ContinuousBatchScheduler._recover``): on an
``UnrecoverableEngineError`` it rebuilds the engine (same compiled-program
bounds — the jitted functions survive, only pools are replaced), requeues
every journaled live request through normal admission (cache cold, so
replay is a real prefill, but output stays bitwise identical under greedy),
cancels deadline-expired requests typed, and re-arms the breaker HALF_OPEN.
Streams see a pause, not an error."""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class JournalEntry:
    """Write-ahead record of one live request — the minimal host-side state
    from which re-admission regenerates everything the engine held."""

    uid: int
    prompt: List[int]
    #: committed generated tokens: emitted to the consumer, hence final.
    #: Speculative overrun never lands here — the scheduler commits only
    #: the accepted prefix, and rollback discards tokens that were never
    #: emitted (docs/SERVING.md) — so this list is append-only.
    tokens: List[int]
    max_new_tokens: int
    priority: int
    deadline: Optional[float]
    arrival_time: float
    eos_token: Optional[int]
    #: per-request decoding policy (a ``serve.sampling.SamplingParams`` —
    #: typed ``object`` because resilience never imports serve): replayed
    #: sampling re-derives every token's PRNG key from (seed, absolute
    #: position), so carrying the params IS the whole reproducibility
    #: contract — ``None`` stays plain greedy and serializes exactly as
    #: the pre-sampling journal format did
    sampling: Optional[object] = None
    #: multi-tenant QoS identity (docs/SERVING.md "Multi-tenant QoS"):
    #: owning tenant id + resolved SLO-class name. Serialized as the
    #: ``record.v3``/``adopt.v3`` journal kinds so tenant attribution
    #: survives preempt, migration, death replay, and host-crash restore;
    #: ``None``/``None`` keeps the exact pre-tenancy byte format.
    tenant: Optional[str] = None
    slo: Optional[str] = None
    commits: int = field(default=0, compare=False)  # commit points synced
    #: migration payload (docs/SERVING.md engine pool): ``detach`` attaches
    #: the live ``Request`` object so the adopting scheduler keeps serving
    #: the SAME object — streaming consumers and the pool's owner map follow
    #: the request across replicas. Never persisted (the durable journal
    #: reconstructs requests from the serialized fields) and excluded from
    #: equality — two entries with identical replay state are the same
    #: record whichever host object carries them.
    request: Optional[object] = field(default=None, compare=False, repr=False)

    def replay_tokens(self) -> List[int]:
        """Prompt plus committed tokens — the ``put`` payload re-admission
        feeds the fresh engine (same contract as ``Request.replay_tokens``)."""
        return list(self.prompt) + list(self.tokens)


class RequestJournal:
    """Host-side write-ahead journal of every in-flight request.

    Lifecycle mirrors the request's: :meth:`record` at submission (before
    the engine ever sees the request — write-ahead), :meth:`commit` at each
    commit point, :meth:`resolve` at any terminal transition
    (DONE/CANCELLED/FAILED). Whatever remains is, by definition, the set of
    requests a fresh engine must replay. Entries keep dict insertion order,
    so replay preserves admission order deterministically (DSTPU005)."""

    def __init__(self):
        self._entries: Dict[int, JournalEntry] = {}
        self.records = 0
        self.commit_points = 0
        self.resolutions = 0
        self.detaches = 0
        self.adoptions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, uid: int) -> bool:
        return uid in self._entries

    def get(self, uid: int) -> Optional[JournalEntry]:
        return self._entries.get(uid)

    def record(self, req) -> JournalEntry:
        """Admission record: copies the prompt (and any committed tokens —
        nonempty when a preempted request's journal was resolved and it is
        being re-recorded) so later mutation of the request cannot
        retroactively edit the journal."""
        e = JournalEntry(uid=req.uid, prompt=list(req.prompt),
                         tokens=list(req.tokens),
                         max_new_tokens=req.max_new_tokens,
                         priority=req.priority, deadline=req.deadline,
                         arrival_time=req.arrival_time,
                         eos_token=req.eos_token,
                         sampling=getattr(req, "sampling", None),
                         tenant=getattr(req, "tenant", None),
                         slo=getattr(req, "slo", None))
        self._entries[req.uid] = e
        self.records += 1
        return e

    def commit(self, req) -> None:
        """Sync the committed-token tail at a commit point. Append-only by
        the overrun-rollback discipline (emitted tokens are never
        retracted), so the sync extends by the new tail — O(new tokens),
        cheap enough for the per-token hot path the DSTPU rules police."""
        e = self._entries.get(req.uid)
        if e is None:
            return
        done = len(e.tokens)
        if len(req.tokens) > done:
            e.tokens.extend(req.tokens[done:])
            e.commits += 1
            self.commit_points += 1

    def resolve(self, uid: int) -> None:
        """Terminal outcome: the request needs no replay, drop the record.
        Idempotent — terminal paths may cross (cancel during fail)."""
        if self._entries.pop(uid, None) is not None:
            self.resolutions += 1

    # ------------------------------------------------------------------
    # ownership transfer (docs/SERVING.md engine pool)
    # ------------------------------------------------------------------
    def detach(self, uid: int) -> JournalEntry:
        """Remove and return a live entry WITHOUT resolving it: the request
        is not terminal, its record is changing owners (cross-replica
        migration / death replay). Counted separately from ``resolutions``
        so the pool-ownership sanitizer can prove no entry was silently
        dropped. Raises ``ValueError`` on an unknown uid — a detach of an
        unrecorded request is a caller bug, never a race."""
        e = self._entries.pop(uid, None)
        if e is None:
            raise ValueError(f"uid {uid} has no journal entry to detach")
        self.detaches += 1
        return e

    def adopt(self, entry: JournalEntry) -> JournalEntry:
        """Install an entry detached from another journal, preserving the
        committed-token record byte for byte (the bitwise replay contract).
        Raises ``ValueError`` if the uid is already journaled here — the
        single-owner invariant ``check_pool_ownership`` enforces across the
        pool holds within one journal too."""
        if entry.uid in self._entries:
            raise ValueError(
                f"uid {entry.uid} is already journaled here — double adopt")
        self._entries[entry.uid] = entry
        self.adoptions += 1
        return entry

    def live(self) -> List[JournalEntry]:
        """Every unresolved entry, in admission order — the replay set."""
        return list(self._entries.values())

    def uids(self) -> List[int]:
        return list(self._entries)


class RecoveryPolicy:
    """Budget + audit trail for hot engine rebuilds.

    ``max_consecutive_rebuilds`` bounds back-to-back rebuilds with no
    proven-healthy dispatch in between; ``note_engine_ok`` (any successful,
    non-breaching engine call) re-arms the budget. ``0`` disables recovery
    outright: every engine loss propagates to the caller. The ``trail``
    records every decision with the scheduler's clock, mirroring the
    breaker's transition trail — the bench persists it."""

    def __init__(self, max_consecutive_rebuilds: int = 3):
        if max_consecutive_rebuilds < 0:
            raise ValueError("max_consecutive_rebuilds must be >= 0, got "
                             f"{max_consecutive_rebuilds}")
        self.max_consecutive_rebuilds = max_consecutive_rebuilds
        self.rebuilds = 0
        self.trail: List[Tuple[float, str]] = []
        self._consecutive = 0

    @property
    def enabled(self) -> bool:
        return self.max_consecutive_rebuilds > 0

    def admit(self, now: float, reason: str) -> bool:
        """One engine loss happened; may a rebuild run? ``False`` means the
        budget is spent (or recovery is disabled) and the scheduler must
        re-raise the loss to its supervisor."""
        self.trail.append((now, f"engine_lost:{reason}"))
        if self._consecutive >= self.max_consecutive_rebuilds:
            self.trail.append((now, "rebuild_budget_exhausted"))
            return False
        return True

    def note_rebuilt(self, now: float, replayed: int, cancelled: int) -> None:
        self.rebuilds += 1
        self._consecutive += 1
        self.trail.append(
            (now, f"rebuilt:replayed={replayed},cancelled={cancelled}"))

    def note_engine_ok(self) -> None:
        """A healthy dispatch on the current incarnation proves the rebuild
        took: the consecutive-rebuild budget re-arms in full."""
        self._consecutive = 0
