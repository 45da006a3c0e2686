"""Per-request stochastic decoding with bitwise-reproducible replay.

A copy of ``deepspeed_tpu/serve/sampling.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

Every guarantee the serving stack certifies — preempt→re-admit, journal
replay after an engine rebuild, pool migration, KV swap-in, durable-journal
host-crash replay — was proved under greedy argmax, where the emitted token
is a pure function of the committed history. Sampling breaks that for free
only if the randomness is *also* a pure function of the committed history.

The scheme (docs/SAMPLING.md):

- every request carries a :class:`SamplingParams` record with an explicit
  31-bit ``seed``;
- the key for the token at absolute position ``p`` (0-based over
  ``prompt + generated``) is ``fold_in(PRNGKey(seed), p)`` — a
  **counter-based** derivation. No global key, no split chain, no
  iteration state: the key depends only on (seed, position), both of
  which replay recomputes exactly. A re-admission that feeds
  ``prompt + committed tokens`` through ``put`` lands on the same
  positions and therefore the same keys, so the sampled continuation is
  bitwise identical to the uninterrupted run — the same property greedy
  gets from argmax being stateless.

The device-side op (:func:`sample_or_argmax`, defined next to the model
ops so ``models`` never imports ``serve``) is a single compiled program
shared by greedy and sampled rows: per row, ``temperature == 0`` selects
the argmax branch (bit-identical to the legacy greedy path), anything
else samples from the temperature/top-k/top-p-shaped distribution under
the row's counter-based key. A batch-level ``lax.cond`` skips the
sampling math entirely when every row is greedy, so pure-greedy traffic
keeps today's compute profile inside the unchanged compiled-program
bounds (ragged ≤4, fused ≤1, verify ≤1).

Logit processors are the structured-generation seam: host-registered
callables that produce additive bias rows (``-inf`` masks) applied
on-device before sampling. Static processors cost one host→device row
scatter at admission; ``dynamic`` processors recompute after every
committed token (the scheduler collapses the fused horizon to 1 for
them, since a K-step scan cannot re-enter the host mid-loop).

Stop sequences are token-id tuples scanned host-side by
:class:`StopScanner` with a rolling tail buffer sized to the longest
stop sequence, so a match spanning a fused-round boundary (or any token
boundary) still fires; over-generated tokens past the match are rolled
back through the engine's existing ``rollback(uid, n)`` primitive.
"""

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# The device op lives with the model ops (models must stay importable
# without serve); re-exported here so serving code has one import site.
from ..models.transformer import sample_or_argmax  # noqa: F401

#: logit-processor contract (docs/SAMPLING.md): called with the request's
#: committed context (prompt + emitted token ids) and the vocab size,
#: returns an additive float32 bias row of shape ``(vocab_size,)`` — use
#: ``-inf`` (or any very negative value) to mask a token — or ``None``
#: for "no constraint right now". A processor with a truthy ``dynamic``
#: attribute is re-evaluated after every committed token.
LogitProcessor = Callable[[Sequence[int], int], Optional[np.ndarray]]

#: seed space: 31-bit non-negative ints — representable in the int32
#: scratch rows the engine ships to the device each dispatch
MAX_SEED = 2 ** 31


def derive_child_seed(seed: int, i: int) -> int:
    """Seed for the ``i``-th stream of an ``n > 1`` fanout. Child 0 keeps
    the parent seed (so ``n=1`` and stream 0 of ``n=3`` are the same
    stream — the property the fanout tests pin); siblings mix the index
    in with a golden-ratio stride, deterministically, so a journal replay
    of an already-fanned-out child never needs the parent record."""
    if i == 0:
        return seed
    return (seed + i * 0x9E3779B1) % MAX_SEED


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy, carried from ``submit()`` through
    admission, the fused K-step decode loop, speculation, the journal,
    and every replay path.

    ``temperature == 0`` (the default) is greedy argmax — bit-identical
    to a request submitted with no sampling at all. ``stop`` holds
    token-id *sequences* (tuples of ints; a bare int is one single-token
    sequence); the request finishes when its output ends with any of
    them. ``logit_bias`` maps token id → additive logit bias (applied
    on-device before temperature). ``processors`` are
    :data:`LogitProcessor` callables — NOT serialized into the durable
    journal (a host-crash replay re-registers them at adoption or runs
    without; see docs/SAMPLING.md).
    """

    temperature: float = 0.0
    top_k: int = 0          #: 0 = disabled; else keep the k highest logits
    top_p: float = 1.0      #: 1.0 = disabled; else nucleus mass cutoff
    seed: int = 0
    n: int = 1              #: fanout: n independent streams off one prompt
    best_of: Optional[int] = None
    stop: Tuple[Tuple[int, ...], ...] = ()
    logit_bias: Tuple[Tuple[int, float], ...] = ()
    processors: Tuple[LogitProcessor, ...] = field(default=(), compare=False)

    def __post_init__(self):
        if not (0.0 <= float(self.temperature) < float("inf")):
            raise ValueError(f"temperature must be finite and >= 0, "
                             f"got {self.temperature}")
        if int(self.top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 < float(self.top_p) <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not (0 <= int(self.seed) < MAX_SEED):
            raise ValueError(
                f"seed must be in [0, 2**31), got {self.seed}")
        if int(self.n) < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.best_of is not None and int(self.best_of) < int(self.n):
            raise ValueError(
                f"best_of ({self.best_of}) must be >= n ({self.n})")
        # normalize stop: a bare int or flat int sequence becomes tuples
        stops: List[Tuple[int, ...]] = []
        for s in (self.stop if isinstance(self.stop, (list, tuple))
                  else (self.stop,)):
            if isinstance(s, (int, np.integer)):
                stops.append((int(s),))
            else:
                seq = tuple(int(t) for t in s)
                if not seq:
                    raise ValueError("empty stop sequence")
                stops.append(seq)
        object.__setattr__(self, "stop", tuple(stops))
        # normalize logit_bias: dict or pair-iterable -> sorted pair tuple
        lb = self.logit_bias
        if isinstance(lb, dict):
            pairs = lb.items()
        else:
            pairs = tuple(lb)
        norm = tuple(sorted((int(t), float(b)) for t, b in pairs))
        for t, _ in norm:
            if t < 0:
                raise ValueError(f"logit_bias token id {t} < 0")
        object.__setattr__(self, "logit_bias", norm)
        object.__setattr__(self, "processors", tuple(self.processors))

    # -- derived properties -------------------------------------------
    @property
    def is_greedy(self) -> bool:
        """True when token *selection* is argmax (bias/processors may
        still shape the logits; stop sequences may still end it)."""
        return float(self.temperature) == 0.0

    @property
    def needs_engine(self) -> bool:
        """True when the engine must know about this request (sampled
        selection, or device-applied bias rows). Pure stop-sequence
        params are host-side only."""
        return (not self.is_greedy) or bool(self.logit_bias) or bool(
            self.processors)

    @property
    def dynamic(self) -> bool:
        """True when any processor re-evaluates per committed token."""
        return any(getattr(p, "dynamic", False) for p in self.processors)

    def child(self, i: int) -> "SamplingParams":
        """Concrete single-stream params for fanout stream ``i`` — n=1,
        derived seed, same shaping. Journal records hold ONLY these, so
        replay never re-fans-out."""
        return replace(self, n=1, best_of=None,
                       seed=derive_child_seed(self.seed, i))

    # -- durable-journal serialization (processors excluded) ----------
    def to_dict(self) -> dict:
        d = {"temperature": float(self.temperature),
             "top_k": int(self.top_k), "top_p": float(self.top_p),
             "seed": int(self.seed), "n": int(self.n)}
        if self.best_of is not None:
            d["best_of"] = int(self.best_of)
        if self.stop:
            d["stop"] = [list(s) for s in self.stop]
        if self.logit_bias:
            d["logit_bias"] = [[t, b] for t, b in self.logit_bias]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingParams":
        return cls(temperature=d.get("temperature", 0.0),
                   top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
                   seed=d.get("seed", 0), n=d.get("n", 1),
                   best_of=d.get("best_of"),
                   stop=tuple(tuple(s) for s in d.get("stop", ())),
                   logit_bias=tuple((int(t), float(b))
                                    for t, b in d.get("logit_bias", ())))


def combined_bias(params: SamplingParams, vocab_size: int,
                  context: Sequence[int] = ()) -> Optional[np.ndarray]:
    """The additive bias row the engine scatters into its device-resident
    per-slot pool: static ``logit_bias`` plus every processor's mask for
    ``context``. ``None`` = no constraint (the engine keeps the slot's
    row zero, and greedy selection is untouched by ``logits + 0``)."""
    row: Optional[np.ndarray] = None
    if params.logit_bias:
        row = np.zeros(vocab_size, dtype=np.float32)
        for tok, bias in params.logit_bias:
            if tok >= vocab_size:
                raise ValueError(
                    f"logit_bias token id {tok} >= vocab size {vocab_size}")
            row[tok] += bias
    for proc in params.processors:
        mask = proc(list(context), vocab_size)
        if mask is None:
            continue
        mask = np.asarray(mask, dtype=np.float32)
        if mask.shape != (vocab_size,):
            raise ValueError(
                f"logit processor returned shape {mask.shape}, "
                f"expected ({vocab_size},)")
        row = mask.copy() if row is None else row + mask
    return row


class StopScanner:
    """Host-side stop-sequence matcher with a rolling tail buffer sized
    to the longest stop sequence, so matches spanning token boundaries
    (and fused-round boundaries) fire on the completing token.

    ``history`` seeds the tail — re-admission, migration, and journal
    replay reconstruct the scanner from the request's committed tokens,
    so the scan is as replay-deterministic as the tokens themselves.
    ``push`` returns the matched stop sequence's length (0 = no match).
    """

    __slots__ = ("stops", "maxlen", "tail")

    def __init__(self, stops: Iterable[Sequence[int]],
                 history: Sequence[int] = ()):
        self.stops: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(t) for t in s) for s in stops)
        self.maxlen = max((len(s) for s in self.stops), default=0)
        self.tail: deque = deque(maxlen=self.maxlen or 1)
        for t in list(history)[-self.maxlen:]:
            self.tail.append(int(t))

    def push(self, tok: int) -> int:
        if not self.stops:
            return 0
        self.tail.append(int(tok))
        tl = tuple(self.tail)
        for s in self.stops:
            if len(tl) >= len(s) and tl[-len(s):] == s:
                return len(s)
        return 0
