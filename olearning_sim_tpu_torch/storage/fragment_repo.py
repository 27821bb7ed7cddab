"""Gradient-fragment consumption (server-side receipt of client updates).

The reference pulls *fragments* — per-client model updates plus training
metrics — off a Pulsar topic via ``JsonFragmentRepo``/``ProtoFragmentRepo``
(``ofl_commons/infrastructure/FragmentRepo/json_fragment_repo.py:8-43``,
``proto_fragment_repo.py:5-38``); the base ``Fragment`` model was never
released (SURVEY.md section 2.6), so it is re-specified here from the fields
visible in the demos (``metrics.train_tp_fragment`` et al.).

In the rebuild the fast path never leaves the device (aggregation is a
collective), so fragments are the *escape-hatch* transport: external operators
and cross-process deployments publish fragments onto a queue, and the
aggregator-side consumer drains them. ``QueueFragmentRepo`` is the in-process
transport; the deviceflow ``InboundRoom`` satisfies the same producer contract.

A copy of the JAX package's ``storage/fragment_repo.py`` over the port's
resilience module; ``ResilientFragmentRepo`` takes its retry policy always
and no log hook, as the port's ``ResilientFileRepo`` does.
"""

from __future__ import annotations

import dataclasses
import json
import queue
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Fragment:
    """One client's update: identity, payload, and training metrics."""

    task_id: str
    client_id: str
    round_idx: int
    payload: Any = None  # model delta / weights, serialized by the producer
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)

    def serialize(self) -> str:
        return json.dumps({
            "task_id": self.task_id,
            "client_id": self.client_id,
            "round_idx": self.round_idx,
            "payload": self.payload,
            "metrics": self.metrics,
        })

    @classmethod
    def deserialize(cls, data: str) -> "Fragment":
        obj = json.loads(data)
        return cls(
            task_id=obj["task_id"],
            client_id=obj["client_id"],
            round_idx=int(obj["round_idx"]),
            payload=obj.get("payload"),
            metrics={k: float(v) for k, v in obj.get("metrics", {}).items()},
        )


class FragmentRepo:
    """Consumer interface: blocking pull of the next fragment."""

    def put_fragment(self, fragment: Fragment) -> None:
        raise NotImplementedError

    def get_fragment(self, timeout: Optional[float] = None) -> Optional[Fragment]:
        raise NotImplementedError

    def drain(self, max_items: int = 0) -> List[Fragment]:
        """Non-blocking drain of everything currently queued."""
        out: List[Fragment] = []
        while max_items <= 0 or len(out) < max_items:
            frag = self.get_fragment(timeout=0)
            if frag is None:
                break
            out.append(frag)
        return out


class QueueFragmentRepo(FragmentRepo):
    """In-process queue transport (the single-host Pulsar replacement)."""

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue[Fragment]" = queue.Queue(maxsize=maxsize)

    def put_fragment(self, fragment: Fragment) -> None:
        self._q.put(fragment)

    def get_fragment(self, timeout: Optional[float] = None) -> Optional[Fragment]:
        try:
            if timeout == 0:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


class ResilientFragmentRepo(FragmentRepo):
    """Retry/backoff + fault injection around any fragment transport.

    A cross-process transport (Pulsar-alike, gRPC stream) drops and times out;
    this wrapper gives the aggregator-side consumer the same retry discipline
    as file I/O. Fault-injection points: ``fragment.put``, ``fragment.get``.
    """

    def __init__(self, inner: FragmentRepo, retry_policy, task_id: str = ""):
        self.inner = inner
        self.retry_policy = retry_policy
        self.task_id = task_id

    def put_fragment(self, fragment: Fragment) -> None:
        from olearning_sim_tpu_torch.resilience import faults

        def op():
            faults.inject("fragment.put", context=fragment.client_id,
                          task_id=self.task_id)
            self.inner.put_fragment(fragment)

        self.retry_policy.call(op, point="fragment.put", task_id=self.task_id)

    def get_fragment(self, timeout: Optional[float] = None) -> Optional[Fragment]:
        from olearning_sim_tpu_torch.resilience import faults

        def op():
            faults.inject("fragment.get", task_id=self.task_id)
            return self.inner.get_fragment(timeout=timeout)

        return self.retry_policy.call(op, point="fragment.get", task_id=self.task_id)


class JsonFragmentRepo(QueueFragmentRepo):
    """JSON-wire variant (reference ``json_fragment_repo.py:8-43``): producers
    enqueue serialized strings, the consumer parses on receipt."""

    def put_serialized(self, data: str) -> None:
        self.put_fragment(Fragment.deserialize(data))
