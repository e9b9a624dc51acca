"""Advisory + inference request schema (paper Fig. 10/11).

An advisory request is a cheap, early hint that a session's next inference
request is imminent: chatbots fire one when the user starts typing
(no expected_arrival, no ordering); agent frameworks fire one when the
upstream agent starts running, with a profiled lower-bound arrival time.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

_req_counter = itertools.count()


@dataclass
class AdvisoryRequest:
    session_id: str
    model_id: str = "default"
    expected_arrival: Optional[float] = None   # seconds from issue, or None
    ordered: bool = False
    priority: Optional[int] = None             # higher = more important
    issued_at: float = 0.0
    # node group serving this session's architecture: a recurrent-state
    # session can only land on a node whose backend holds its state kind
    group: str = "default"


@dataclass
class InferenceRequest:
    session_id: str
    prompt_tokens: int                          # new tokens this turn
    max_new_tokens: int                         # response length target
    arrival: float = 0.0
    priority: int = 0
    group: str = "default"                      # node group (architecture)
    request_id: int = field(default_factory=lambda: next(_req_counter))
    # real-mode payload (None in simulation)
    prompt_ids: Optional[list] = None
    # real-mode result: token ids generated for this request (RealBackend
    # appends across preemption/resume; None in simulation)
    output_ids: Optional[list] = None
    # --- filled by the runtime ---
    node_id: Optional[int] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    generated: int = 0
    cached_tokens: int = 0                      # session KV available at arrival

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def e2e(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    @property
    def normalized_latency(self) -> Optional[float]:
        if self.e2e is None or self.generated == 0:
            return None
        return self.e2e / self.generated

    @property
    def tpot(self) -> Optional[float]:
        if (self.finished_at is None or self.first_token_at is None
                or self.generated <= 1):
            return None
        return (self.finished_at - self.first_token_at) / (self.generated - 1)


@dataclass
class SessionMeta:
    session_id: str
    priority: int = 0
    total_tokens: int = 0          # KV length currently cached
    kv_node: Optional[int] = None  # node currently holding the KV
    turns: int = 0
    group: str = "default"         # immutable once set off the default
