"""Durable request journal: append-only on-disk persistence (docs/RESILIENCE.md).

A copy of ``deepspeed_tpu/resilience/journal_store.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

:class:`RequestJournal` is host-memory only — it survives the *engine* by
construction, but a crash of the *host process* loses every in-flight
request (ROADMAP: the gap the durable journal closes, and the natural
first step of the engine pool: a restarted host replays its journal
exactly like a survivor replica absorbs a dead one's).

:class:`DurableRequestJournal` extends the journal with a write-ahead log
on disk, adapting the checkpoint engine's durability protocol
(``runtime/checkpoint_engine/native_checkpoint_engine.py``: payload →
meta → CRC32-verified manifest written LAST) to an append-only stream:

- **one CRC-framed line per mutation** — ``crc32(payload) payload\\n``
  with a JSON payload. The frame plays the manifest's role at record
  granularity: a record is durable iff its complete line (CRC prefix,
  payload, trailing newline) reached the disk. There is no partially
  valid record, only present or absent — the same all-or-nothing contract
  the manifest-last rename gives a whole checkpoint.
- **torn tails truncate, never propagate**: on open, the log is folded
  record by record; the first invalid frame (short line at EOF, CRC
  mismatch, undecodable payload) marks the torn tail of an interrupted
  write — the file is truncated back to the last valid record and the
  typed counter ``corrupt_tail_truncations`` records the event (with
  ``corrupt_tail_dropped_bytes`` for forensics). Everything before the
  tear replays; a commit that never fully landed is re-derived by the
  normal recovery replay (the token it recorded is regenerated bitwise
  under greedy).
- **log kinds mirror the journal surface**: ``record`` / ``commit`` /
  ``resolve`` and the ownership-transfer pair ``detach`` / ``adopt``
  (an adopt logs the FULL entry, so each replica's log is self-contained
  — replaying one file never needs another replica's).
- **versioned entry kinds**: an entry carrying sampling params
  (docs/SAMPLING.md) is written as ``record.v2`` / ``adopt.v2`` with a
  ``sampling`` field; plain greedy entries keep emitting the original
  kinds byte-for-byte, so pre-sampling logs replay unchanged and logs
  written by this version are readable by pre-sampling readers for
  every greedy request (v2 kinds fold to nothing there — the documented
  unknown-kind rule — losing only the sampled requests they describe).
  ``record.v3`` / ``adopt.v3`` extend the ladder with the multi-tenant
  identity payload (``tenant`` + ``slo``, sampling included when
  present): tenant attribution survives preempt, migration, death
  replay, and host-crash restore, while untenanted entries keep their
  v1/v2 bytes pinned.

Writes are flushed per append (the commit path is the per-token hot path
the DSTPU rules police: one buffered ``write`` + ``flush``, no fsync by
default); ``fsync=True`` upgrades every append to a true durability
barrier for hosts where the page cache is not trusted to survive.

**Compaction** (:meth:`DurableRequestJournal.compact`): append-only logs
grow without bound under long-lived serving — every resolved request
leaves its record/commit/resolve lines behind as dead weight. When the
dead-record ratio crosses ``compact_ratio`` (checked at the
entry-removal points, ``resolve``/``detach``), the journal rewrites just
its live entries to a fresh file under the same manifest-last protocol a
checkpoint uses: full entries (committed tokens inline, ``.v2`` +
sampling preserved) are framed into ``<path>.compact``, fsync'd, and
``os.replace``-renamed over the log — atomic, so a crash at ANY point
leaves either the old complete log or the new complete log, never a mix.
A stale ``.compact`` temp file found at open (crash mid-compact) is
discarded: the rename never happened, so the primary log is the truth.
``compactions`` / ``compacted_bytes`` count the work."""

import json
import os
import zlib
from typing import Optional

from ..utils.logging import logger
from .recovery import JournalEntry, RequestJournal


def _frame(payload: str) -> str:
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n"


def _unframe(line: str) -> Optional[dict]:
    """Parse one framed line; None on any tear (bad frame, CRC mismatch,
    undecodable payload) — the caller truncates from there."""
    if not line.endswith("\n") or len(line) < 10 or line[8] != " ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:-1]
    if zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF != crc:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) and "kind" in rec else None


class DurableRequestJournal(RequestJournal):
    """A :class:`RequestJournal` whose every mutation is logged to
    ``path`` before control returns — write-ahead on disk, not just in
    memory. Opening an existing path replays the log (fold: record/adopt
    install, commit extends, resolve/detach drop), truncating a torn tail
    to the last valid record. The in-memory surface and counters behave
    exactly like the base class; ``replayed_records`` counts the folded
    log records and ``corrupt_tail_truncations`` the tail repairs."""

    def __init__(self, path: str, *, fsync: bool = False,
                 compact_ratio: Optional[float] = 0.5,
                 compact_min_records: int = 256):
        super().__init__()
        self.path = path
        self.fsync = fsync
        #: auto-compaction policy: when the fraction of dead records in
        #: the file crosses ``compact_ratio`` (and the file holds at
        #: least ``compact_min_records`` records), resolve/detach trigger
        #: :meth:`compact`. ``None`` disables auto-compaction.
        self.compact_ratio = compact_ratio
        self.compact_min_records = compact_min_records
        self.replayed_records = 0
        #: typed counter (docs/RESILIENCE.md): torn-tail repairs performed
        #: at open — each is one truncation back to the last valid record
        self.corrupt_tail_truncations = 0
        self.corrupt_tail_dropped_bytes = 0
        #: compaction counters (docs/RESILIENCE.md): rewrites completed
        #: and total bytes reclaimed by them
        self.compactions = 0
        self.compacted_bytes = 0
        #: stale ``.compact`` temp files discarded at open (crash
        #: mid-compact: the rename never happened, the primary log wins)
        self.stale_compact_cleanups = 0
        #: records currently in the on-disk file (live + dead) — the
        #: denominator of the auto-compaction ratio
        self._file_records = 0
        self._fh = None
        tmp = path + ".compact"
        if os.path.exists(tmp):
            self.stale_compact_cleanups += 1
            logger.warning(
                "durable journal %s: discarding stale compaction temp %s "
                "(crash mid-compact — the primary log is authoritative)",
                path, tmp)
            os.remove(tmp)
        self._replay()
        self._file_records = self.replayed_records
        self._fh = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------------
    # log replay + tail repair
    # ------------------------------------------------------------------
    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        valid_end = 0
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                rec = _unframe(line)
                if rec is None:
                    break
                self._fold(rec)
                self.replayed_records += 1
                valid_end += len(line.encode("utf-8"))
        size = os.path.getsize(self.path)
        if valid_end < size:
            self.corrupt_tail_truncations += 1
            self.corrupt_tail_dropped_bytes += size - valid_end
            logger.warning(
                "durable journal %s: corrupt tail — truncating %d byte(s) "
                "back to the last valid record (%d replayed)", self.path,
                size - valid_end, self.replayed_records)
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)

    def _fold(self, rec: dict) -> None:
        kind = rec["kind"]
        if kind in ("record", "adopt", "record.v2", "adopt.v2",
                    "record.v3", "adopt.v3"):
            sampling = None
            if "sampling" in rec:
                # lazy import: resilience stays importable without serve
                # (module-level would be a serve<->resilience cycle)
                from ..serve.sampling import SamplingParams
                sampling = SamplingParams.from_dict(rec["sampling"])
            e = JournalEntry(
                uid=rec["uid"], prompt=list(rec["prompt"]),
                tokens=list(rec["tokens"]),
                max_new_tokens=rec["max_new_tokens"],
                priority=rec["priority"], deadline=rec["deadline"],
                arrival_time=rec["arrival_time"], eos_token=rec["eos_token"],
                sampling=sampling, tenant=rec.get("tenant"),
                slo=rec.get("slo"))
            self._entries[e.uid] = e
        elif kind == "commit":
            e = self._entries.get(rec["uid"])
            if e is not None:
                e.tokens.extend(rec["tokens"])
        elif kind in ("resolve", "detach"):
            self._entries.pop(rec["uid"], None)
        # unknown kinds fold to nothing: forward compatibility — a newer
        # writer's records must not wedge an older reader's recovery

    # ------------------------------------------------------------------
    # write-ahead appends
    # ------------------------------------------------------------------
    def _append(self, rec: dict) -> None:
        if self._fh is None:  # replay phase: nothing to re-log
            return
        self._fh.write(_frame(json.dumps(rec, separators=(",", ":"))))
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._file_records += 1

    @staticmethod
    def _entry_rec(kind: str, e: JournalEntry) -> dict:
        rec = {"kind": kind, "uid": e.uid, "prompt": list(e.prompt),
               "tokens": list(e.tokens),
               "max_new_tokens": e.max_new_tokens, "priority": e.priority,
               "deadline": e.deadline, "arrival_time": e.arrival_time,
               "eos_token": e.eos_token}
        sp = getattr(e, "sampling", None)
        tenant = getattr(e, "tenant", None)
        if tenant is not None:
            # versioned kind ladder: a tenant-tagged entry is .v3 (tenant
            # + SLO class, sampling when present); a sampled untenanted
            # entry stays .v2; a plain greedy untenanted entry keeps the
            # original framing byte for byte. Older readers fold unknown
            # .v3 kinds to nothing — the documented forward-compat rule —
            # losing only the tenant-tagged requests they describe.
            rec["kind"] = kind + ".v3"
            rec["tenant"] = tenant
            slo = getattr(e, "slo", None)
            if slo is not None:
                rec["slo"] = slo
            if sp is not None:
                rec["sampling"] = sp.to_dict()
        elif sp is not None:
            # ONLY sampled entries pay the format bump — greedy logs stay
            # byte-identical to the pre-sampling framing
            rec["kind"] = kind + ".v2"
            rec["sampling"] = sp.to_dict()
        return rec

    def record(self, req) -> JournalEntry:
        e = super().record(req)
        self._append(self._entry_rec("record", e))
        return e

    def commit(self, req) -> None:
        e = self._entries.get(req.uid)
        done = len(e.tokens) if e is not None else 0
        super().commit(req)
        if e is not None and len(e.tokens) > done:
            # append-only tail sync, mirroring the in-memory commit: only
            # the NEW committed tokens hit the log (O(new) per commit point)
            self._append({"kind": "commit", "uid": req.uid,
                          "tokens": e.tokens[done:]})

    def resolve(self, uid: int) -> None:
        present = uid in self._entries
        super().resolve(uid)
        if present:
            self._append({"kind": "resolve", "uid": uid})
            self._maybe_compact()

    def detach(self, uid: int) -> JournalEntry:
        e = super().detach(uid)
        self._append({"kind": "detach", "uid": uid})
        self._maybe_compact()
        return e

    def adopt(self, entry: JournalEntry) -> JournalEntry:
        e = super().adopt(entry)
        # the FULL entry: this log stays self-contained — its replay never
        # needs the detaching replica's file
        self._append(self._entry_rec("adopt", e))
        return e

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def _maybe_compact(self) -> None:
        """Auto-compaction trigger, checked at the entry-removal points:
        a live entry needs exactly one record in a compacted file, so
        ``1 - live/total`` is the reclaimable (dead) record fraction."""
        if self.compact_ratio is None or self._fh is None:
            return
        if self._file_records < self.compact_min_records:
            return
        dead = 1.0 - len(self._entries) / self._file_records
        if dead >= self.compact_ratio:
            self.compact()

    def compact(self) -> int:
        """Rewrite the log to hold only its live entries (full state —
        committed tokens inline, sampling preserved via the ``.v2``
        kinds) under the manifest-last protocol: frame everything into
        ``<path>.compact``, fsync, then ``os.replace`` over the log.
        Atomic: a crash before the rename leaves the old log complete
        (the stale temp is discarded at next open); after it, the new.
        Returns the bytes reclaimed."""
        if self._fh is None:
            return 0
        old_size = os.path.getsize(self.path)
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as f:
            for uid in list(self._entries):
                f.write(_frame(json.dumps(
                    self._entry_rec("record", self._entries[uid]),
                    separators=(",", ":"))))
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        new_size = os.path.getsize(self.path)
        self._file_records = len(self._entries)
        self.compactions += 1
        self.compacted_bytes += max(0, old_size - new_size)
        logger.info(
            "durable journal %s: compacted %d -> %d byte(s) "
            "(%d live entr%s kept)", self.path, old_size, new_size,
            len(self._entries), "y" if len(self._entries) == 1 else "ies")
        return old_size - new_size

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
