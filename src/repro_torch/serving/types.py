"""Request/response dataclasses for the serving engine.

A `Request` is a prompt plus `SamplingParams`, a (virtual-clock) arrival
time, and optional deadlines; the engine answers with a `Completion`.
These are plain host-side objects — device state lives in the engine's
slot arena.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

GREEDY = 0.0


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    temperature <= 0 is greedy (argmax); top_k = 0 disables top-k
    filtering; eos_id < 0 disables EOS stopping.  `seed` pins the
    request's sampling stream (None derives one from the engine seed and
    the submission index, so runs stay reproducible by default).
    """
    temperature: float = GREEDY
    top_k: int = 0
    max_new_tokens: int = 16
    eos_id: int = -1
    seed: int | None = None


@dataclasses.dataclass(frozen=True)
class SpecStats:
    """Per-request speculative-decoding audit trail.

    `proposed` counts draft-tier proposals the verifier examined;
    `accepted` counts proposals emitted verbatim; `corrections` counts
    tokens the verify tier emitted itself (every non-speculative token —
    the prefill first token included — is a correction, so
    `accepted + corrections == len(Completion.tokens)` always holds).
    """
    proposed: int = 0
    accepted: int = 0
    corrections: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request.

    `arrival` is in engine ticks (one `Engine.step()` = one tick); the
    scheduler will not admit the request before that tick, which is how
    benchmarks replay arrival traces deterministically.  `extras` carries
    family-specific conditioning: "frames" (enc_seq, d_model) for encdec,
    "img_embeds" (n_img_tokens, d_model) for vision-cross models.

    Deadlines are *relative* tick budgets measured from `arrival` (so a
    re-queued attempt, whose arrival is restamped, gets a fresh budget):

      * `ttft_deadline_ticks` — admission-to-first-token budget.  A
        request that cannot emit its first token inside the budget is
        never admitted: the engine sheds it (`finish_reason="shed"`)
        instead of spending prefill on a reply that is already late.
      * `deadline_ticks` — total budget (arrival -> last token).  A
        running request that exhausts it is evicted with its partial
        generation (`finish_reason="deadline"`).

    None (default) disables the respective deadline.  `attempt` is the
    retry ordinal stamped by the fleet router on failover re-queues
    (0 = first attempt); the engine copies it onto the `Completion` so
    exactly-once accounting is auditable end to end.
    """
    request_id: str
    tokens: Sequence[int]
    sampling: SamplingParams = SamplingParams()
    arrival: float = 0.0
    extras: dict[str, Any] | None = None
    ttft_deadline_ticks: float | None = None
    deadline_ticks: float | None = None
    attempt: int = 0


@dataclasses.dataclass
class Completion:
    """The engine's answer: generated ids + scheduling/latency metadata.

    finish_reason: "length" | "eos"      — natural completion;
                   "deadline"            — total deadline hit mid-decode
                                           (partial tokens kept);
                   "shed"                — never admitted: the TTFT
                                           deadline was already blown in
                                           the queue, or the fleet
                                           router exhausted the retry
                                           budget (tokens == []).
    """
    request_id: str
    prompt_len: int
    tokens: list[int]
    finish_reason: str          # "length" | "eos" | "deadline" | "shed"
    arrival: float
    admitted_tick: int          # -1 for shed requests (never admitted)
    finished_tick: int
    ttft_s: float               # ready -> first token (wall clock)
    latency_s: float            # ready -> eviction (wall clock)
    #: inclusive serving iterations from arrival to first token
    #: (first-token tick - arrival + 1): the wall-noise-free TTFT used
    #: by the slot-vs-paged bench gates.  0.0 for shed requests.
    ttft_ticks: float = 0.0
    #: per-request operational footprint (`fleet.meter.RequestCarbon`)
    #: when the engine serves with an energy meter; None otherwise.
    carbon: Any | None = None
    #: retry ordinal of the attempt that produced this completion
    #: (copied from `Request.attempt`; 0 = first attempt).
    attempt: int = 0
    #: tokens served per multiplier tier, e.g. {"exact": 3,
    #: "trunc2x2": 5} — the accuracy-exposure audit trail when the
    #: engine serves with degradation tiers.  Empty for shed requests;
    #: None only for completions minted before tier accounting existed.
    tier_tokens: dict[str, int] | None = None
    #: speculative-decoding acceptance accounting (`SpecStats`) when the
    #: paged engine served the request with a draft tier; None when
    #: speculation was off (slot engine, or no draft configured).
    spec: SpecStats | None = None
