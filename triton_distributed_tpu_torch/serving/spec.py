"""Self-drafting proposer for speculative decode — the port's copy of
the JAX package's ``serving/spec.py`` (``NGramProposer``), host-only.

Prompt-lookup drafting: find the most recent earlier occurrence of the
trailing n-gram of the request's ``prompt + generated`` history and
propose the tokens that followed it. No second model, no device work,
deterministic. The verify side is ``models/dense.dense_verify_step_paged``
on the eager lane and the megakernel's windowed program on the
persistent lane; acceptance is ``models/sampling.accept_longest_prefix``.
"""

from __future__ import annotations

import os


class SpecConfigError(ValueError):
    """A speculative-decode parameter is invalid — named, up front."""


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var, "") or default)
    except ValueError:
        return default


class NGramProposer:
    """Per-slot deterministic n-gram draft of up to ``k`` tokens.

    ``ngram`` is the longest suffix matched (falling back to shorter ones
    down to ``min_ngram``); ``lookback`` bounds how far back the scan
    walks. Defaults come from ``TDTPU_SPEC_NGRAM`` (3),
    ``TDTPU_SPEC_MIN_NGRAM`` (1) and ``TDTPU_SPEC_LOOKBACK`` (512), as in
    the JAX package. ``propose`` returns 0..k tokens; an empty draft
    verifies one position, i.e. one-token decode for that slot."""

    def __init__(self, k: int, *, ngram: int | None = None,
                 min_ngram: int | None = None,
                 lookback: int | None = None):
        if k < 1:
            raise SpecConfigError(
                f"k = {k} invalid: a proposer drafts at least one "
                "candidate token (spec_k=0 disables the lane instead) — "
                "argument k")
        self.k = int(k)
        self.ngram = (int(ngram) if ngram is not None
                      else max(1, _env_int("TDTPU_SPEC_NGRAM", 3)))
        self.min_ngram = (int(min_ngram) if min_ngram is not None
                          else max(1, _env_int("TDTPU_SPEC_MIN_NGRAM", 1)))
        if self.min_ngram > self.ngram:
            raise SpecConfigError(
                f"min_ngram = {self.min_ngram} > ngram = {self.ngram}: "
                "the fallback ladder must descend — arguments "
                "ngram/min_ngram (TDTPU_SPEC_NGRAM/TDTPU_SPEC_MIN_NGRAM)")
        self.lookback = (int(lookback) if lookback is not None
                         else max(1, _env_int("TDTPU_SPEC_LOOKBACK", 512)))

    @property
    def window_tokens(self) -> int:
        """Trailing history tokens the proposer ever examines."""
        return self.lookback + self.ngram

    def propose(self, history, max_tokens: int | None = None) -> list[int]:
        """Draft up to ``min(k, max_tokens)`` tokens continuing
        ``history``. The most recent match wins; a longer n-gram wins
        over shorter fallbacks. Only the trailing ``window_tokens`` are
        examined."""
        cap = self.k if max_tokens is None else min(self.k, max_tokens)
        if cap < 1:
            return []
        hist = [int(t) for t in history[-self.window_tokens:]]
        n = len(hist)
        for g in range(min(self.ngram, n - 1), self.min_ngram - 1, -1):
            key = hist[n - g:]
            # The most recent earlier occurrence with a non-empty
            # continuation (one ending at the tail is the query itself).
            for s in range(n - g - 1, -1, -1):
                if hist[s:s + g] == key:
                    cont = hist[s + g:s + g + cap]
                    if cont:
                        return cont
        return []
