"""Request lifecycle objects for the serving engine (a copy of the JAX
package's numpy-only ``repro.serving.request``, without the regret probe
fields, which wait for the observability slice)."""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

import numpy as np


class RequestStatus(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED_STOPPED = "finished_stopped"     # hit EOS
    FINISHED_LENGTH = "finished_length"       # hit max_new_tokens


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0            # 0 = no top-k
    top_p: float = 1.0        # 1.0 = no nucleus
    greedy: bool = True


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                      # (S,) int32 token ids
    max_new_tokens: int = 64
    eos_token_id: int | None = None
    sampling: SamplingParams = field(default_factory=SamplingParams)

    status: RequestStatus = RequestStatus.WAITING
    output_tokens: list[int] = field(default_factory=list)
    slot: int = -1                          # engine batch slot while active
    prefill_pos: int = 0                    # prompt tokens already consumed
                                            # by chunked prefill
    share_src: int = -1                     # batch row whose prompt-prefix
                                            # pages this request adopted at
                                            # admission (-1 == none)
    shared_tokens: int = 0                  # prompt tokens covered by the
                                            # adopted pages (prefill skipped)
    arrival_time: float = field(default_factory=time.perf_counter)
    admission_time: float = 0.0             # perf_counter when the scheduler
                                            # assigned a batch slot (prefix-
                                            # sharing admissions may be
                                            # DEFERRED several steps past
                                            # arrival waiting for the shared
                                            # prefix to finish prefilling)
    first_token_time: float = 0.0           # perf_counter at first emission
    prefill_time: float = 0.0               # wall time spent in prefill steps
                                            # (adopters: only the NON-shared
                                            # chunks — adopted pages cost no
                                            # prefill compute)
    decode_times: list[float] = field(default_factory=list)

    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)

    @property
    def prompt_remaining(self) -> int:
        return len(self.prompt) - self.prefill_pos

    @property
    def ttft(self) -> float:
        """Time-to-first-token (s); 0.0 until the first token is emitted.

        ALWAYS dated from ``arrival_time`` — the user-perceived latency.
        For a prefix-sharing adopter the prefill chunks are shorter (the
        adopted pages are skipped), but any queueing/deferral time between
        arrival and admission still counts: TTFT must never shrink just
        because the request waited for its prefix to become adoptable.
        ``queue_time`` exposes the waiting component separately."""
        if not self.first_token_time:
            return 0.0
        return self.first_token_time - self.arrival_time

    @property
    def queue_time(self) -> float:
        """Arrival -> slot assignment (s); 0.0 until admitted. Includes
        prefix-sharing deferral (waiting for the shared prefix's owner to
        finish prefilling it)."""
        if not self.admission_time:
            return 0.0
        return self.admission_time - self.arrival_time

    @property
    def finished(self) -> bool:
        return self.status in (RequestStatus.FINISHED_STOPPED,
                               RequestStatus.FINISHED_LENGTH)
