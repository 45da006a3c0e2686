"""Speculative decoding: draft proposers + acceptance policy
(docs/SERVING.md).

A copy of ``deepspeed_tpu/serve/speculation.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's, except that
:class:`DraftModelProposer` runs the port's ``draft_greedy`` on torch tensors
on the draft weights' device (the flash forward kernel on the card).

Speculative decoding splits every decode round into a cheap **draft** and a
batched **verify**: a proposer guesses the next ``k`` tokens, the target
model checks all of them in ONE position-parallel dispatch
(``InferenceEngineV2.verify_multi``), the scheduler commits the longest
accepted prefix plus the one free token the verifier produced at the first
mismatch, and ``rollback`` reclaims the rest refcount-exactly. Verification
is greedy-exact: every emitted token is the target model's own argmax, so
output is bitwise identical to non-speculative decode — a bad proposer can
only cost throughput, never correctness.

Two proposers ship behind the same :class:`DraftProposer` interface:

- :class:`PromptLookupProposer` — **self-drafting**: match the context's own
  trailing n-gram against its earlier prompt+history and propose the tokens
  that followed the match (prompt-lookup / n-gram decoding). No second
  model, no extra memory; extremely effective whenever generation revisits
  its context — extraction, summarization with quotes, code edits, or the
  short cycles greedy decoding settles into.
- :class:`DraftModelProposer` — a small ``TransformerLM`` drafts the
  continuation with one fused greedy scan over a fixed, position-rebased
  context window (``TransformerLM.draft_greedy``). One compiled shape total.

:class:`SpecPolicy` owns the per-request acceptance bookkeeping the
scheduler drives: an acceptance-rate EMA per uid sets an **adaptive draft
budget** (the generalization of ``_effective_horizon``: the horizon worth
speculating is the expected accepted length), and a collapsed EMA degrades
that request to the plain fused path (budget 0) until ``revive_after``
rounds pass — speculation costs a K-wide verify per emitted token when
nothing is accepted, so it must switch itself off.
"""

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..utils.logging import logger
from ..utils.tree import tree_leaves


class DraftProposer:
    """Interface: guess the next ``k`` tokens of ``context``.

    ``propose`` returns UP TO ``k`` draft tokens continuing ``context``
    (the committed prompt + emitted tokens, whose last entry is the token
    about to be fed) — or ``[]`` when it has no guess, which makes the
    scheduler fall back to the plain fused path for that round.
    ``observe``/``forget`` are optional per-request feedback hooks."""

    def propose(self, uid: int, context: Sequence[int],
                k: int) -> List[int]:
        raise NotImplementedError

    def observe(self, uid: int, proposed: int, accepted: int) -> None:
        """Acceptance feedback after one verified round (optional hook)."""

    def forget(self, uid: int) -> None:
        """The request finished/failed — drop any per-uid state."""


class PromptLookupProposer(DraftProposer):
    """Self-drafting by prompt lookup: find the most recent earlier
    occurrence of the context's trailing ``n``-gram (longest ``n`` first,
    ``max_ngram`` down to ``min_ngram``) and propose the tokens that
    followed it. Overlapping matches are allowed, so short greedy cycles
    (period < n) draft themselves perfectly. Pure host work, O(n · len) per
    call over bounded serving contexts."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, uid: int, context: Sequence[int],
                k: int) -> List[int]:
        if k <= 0:
            return []
        ext = [int(t) for t in context]
        base = len(ext)
        # iterative extension: when a match's continuation runs off the end
        # of the context (a cycle shorter than the budget), re-run the
        # lookup over context + draft-so-far — the cycle extrapolates to
        # the full budget instead of stopping at the context edge
        while len(ext) - base < k:
            nxt = self._lookup_one(ext, k - (len(ext) - base))
            if not nxt:
                break
            ext.extend(nxt)
        return ext[base:]

    def _lookup_one(self, ctx: List[int], k: int) -> List[int]:
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(ctx) <= n:
                continue
            pat = ctx[-n:]
            # most recent strictly-earlier occurrence wins: recency tracks
            # the current decoding regime better than the first occurrence
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    return ctx[i + n:i + n + k]
        return []


class DraftModelProposer(DraftProposer):
    """A small ``TransformerLM`` drafts ``k`` tokens with one greedy loop
    (``draft_greedy``) over a fixed ``window``-token, position-rebased
    context tail — one shape regardless of context length or the adaptive
    budget (the loop always drafts ``max_draft`` tokens; the host slices).
    Draft quality degrades on rebasing long contexts; the verifier makes
    that a throughput concern only. Runs on the device of ``params`` (for
    ``params=None``, weights drawn on ``device`` from seed 0)."""

    def __init__(self, model, params=None, *, window: int = 64,
                 max_draft: int = 8, device="cuda"):
        from ..accelerator import resolve_device

        if max_draft >= window:
            raise ValueError(f"max_draft {max_draft} must leave context "
                             f"room in window {window}")
        self.model = model
        if params is None:
            params = model.init_params(
                torch.Generator(device=resolve_device(device)).manual_seed(0))
        self.params = params
        self.window = window
        self.max_draft = max_draft
        self._win = np.zeros((window,), np.int32)  # reused host scratch
        self._device = next(tree_leaves(params)).device

    def propose(self, uid: int, context: Sequence[int],
                k: int) -> List[int]:
        if k <= 0 or not context:
            return []
        keep = min(len(context), self.window - self.max_draft)
        self._win.fill(0)
        self._win[:keep] = context[len(context) - keep:]
        ys = self.model.draft_greedy(self.params, torch.from_numpy(self._win).to(self._device),
                                     keep, self.max_draft)
        # one copy per draft round: the draft tokens must reach the host to
        # enter verify_multi's staged segments
        ys = ys.cpu().numpy()  # dstpu-lint: ignore[DSTPU001]
        return [int(t) for t in ys[:k]]


class SpecPolicy:
    """Per-request acceptance EMA → adaptive draft budget (the scheduler's
    speculation brain).

    ``budget(uid, k_max)`` is the draft horizon worth verifying for this
    request: ``round(ema · k_max)``, at least 1 while the EMA is healthy —
    the expected accepted length, which is what ``_effective_horizon``
    generalizes to under speculation. When the EMA falls below ``floor``
    the budget is 0 (the request degrades to the plain fused path) until
    ``revive_after`` degraded rounds pass, after which one probe draft
    tests whether the workload turned draftable again."""

    def __init__(self, proposer: DraftProposer, *, ema_alpha: float = 0.4,
                 floor: float = 0.35, init_rate: float = 1.0,
                 revive_after: int = 8):
        self.proposer = proposer
        self.ema_alpha = ema_alpha
        self.floor = floor
        self.init_rate = init_rate
        self.revive_after = revive_after
        self._ema: Dict[int, float] = {}
        self._degraded: Dict[int, int] = {}  # uid -> rounds since collapse

    def rate(self, uid: int) -> float:
        return self._ema.get(uid, self.init_rate)

    def budget(self, uid: int, k_max: int) -> int:
        rate = self.rate(uid)
        if rate < self.floor:
            since = self._degraded.get(uid, 0) + 1
            if since <= self.revive_after:
                self._degraded[uid] = since
                return 0
            self._degraded[uid] = 0  # probe round
            return 1
        return max(1, min(k_max, int(round(rate * k_max))))

    def collect(self, uids: Sequence[int],
                context_of: Callable[[int], Sequence[int]],
                k_max: int) -> Dict[int, List[int]]:
        """Drafts for one decode round: ``{uid: draft}`` for every fed uid
        whose budget is positive and whose proposer found a guess. Empty
        dict = nothing worth verifying, run the fused path."""
        drafts: Dict[int, List[int]] = {}
        for uid in uids:
            b = self.budget(uid, k_max)
            if b <= 0:
                continue
            ds = self.proposer.propose(uid, context_of(uid), b)
            if ds:
                drafts[uid] = ds[:b]
        return drafts

    def observe(self, uid: int, proposed: int, accepted: int) -> None:
        if proposed <= 0:
            return
        rate = accepted / proposed
        prev = self._ema.get(uid)
        self._ema[uid] = (rate if prev is None
                          else self.ema_alpha * rate
                          + (1.0 - self.ema_alpha) * prev)
        if self._ema[uid] >= self.floor:
            self._degraded.pop(uid, None)
        self.proposer.observe(uid, proposed, accepted)

    def forget(self, uid: int) -> None:
        self._ema.pop(uid, None)
        self._degraded.pop(uid, None)
        try:
            self.proposer.forget(uid)
        except Exception as e:  # a proposer bug must not wedge teardown
            logger.warning("speculation: proposer.forget(%d) raised: %s",
                           uid, e)
