"""Request objects and lifecycle states for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"     # admitted, prompt partially processed (chunked)
    RUNNING = "running"     # decoding
    DONE = "done"
    FAILED = "failed"       # replica loss etc.; re-queued by the engine


@dataclasses.dataclass
class Request:
    rid: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    prompt: Optional[List[int]] = None       # None -> synthetic random ids
    priority: int = 0                        # overload class:
    #                                          0=interactive, 1=batch,
    #                                          2=background (lower = keep)

    # runtime
    state: RequestState = RequestState.QUEUED
    slot: int = -1                            # engine batch slot
    prefill_done: int = 0                     # tokens of prompt processed
    tokens_out: int = 0
    admitted_time: Optional[float] = None     # engine clock when the
    #                                           scheduler last took it
    #                                           from the queue
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prev_token_time: Optional[float] = None
    retries: int = 0                          # engine-side failure requeues
    attempts: int = 0                         # client-side re-submissions
    submit_time: Optional[float] = None       # last (re)submission; None ->
    #                                           arrival_time (first attempt)

    @property
    def submitted_at(self) -> float:
        return (self.arrival_time if self.submit_time is None
                else self.submit_time)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time-per-output-token over the decode phase."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = max(self.tokens_out - 1, 1)
        return (self.finish_time - self.first_token_time) / n
