"""The port's copy of the JAX package's ``serve/load_balancing_policies.py``
(standard library only; it imports nothing of that package). The picks
are the same for the same requests and replica sets, so a fleet that
mixes both packages' load balancers routes one way.

Load-balancing policies.

Reference analog: sky/serve/load_balancing_policies.py
(LoadBalancingPolicy:22, RoundRobinPolicy:47), extended with a
prefix-affinity policy for the decode engine's shared-prefix KV cache
(serve/decode_engine.py): a replica's cache only pays off if requests
sharing a prompt prefix keep landing on it, which is a ROUTING
property the replica cannot provide for itself.

``select_replica`` takes an optional request dict ({"path", "body"})
so content-aware policies can route on the payload; stateless policies
ignore it. ``exclude`` names replicas the caller has ruled out for
this attempt (already failed this request, or breaker-ejected) — the
LB's retry path re-invokes the policy with the failed target excluded
so the second attempt lands elsewhere. ``report_done`` lets the LB
return the in-flight slot after the response completes (least-loaded
accounting).
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
from typing import Collection, Dict, List, Optional


class LoadBalancingPolicy:
    def set_ready_replicas(self, urls: List[str]) -> None:
        raise NotImplementedError

    def select_replica(self, request: Optional[dict] = None,
                       exclude: Optional[Collection[str]] = None
                       ) -> Optional[str]:
        raise NotImplementedError

    def report_done(self, url: str) -> None:
        """The request routed to ``url`` finished (stream closed or
        failed). Default: stateless policies don't track load."""

    def ready_replicas(self) -> List[str]:
        """Current ready set (for the LB's /metrics replica scrape)."""
        raise NotImplementedError


class RoundRobinPolicy(LoadBalancingPolicy):
    def __init__(self):
        self._lock = threading.Lock()
        self._urls: List[str] = []
        self._cycle = itertools.cycle([])

    def set_ready_replicas(self, urls: List[str]) -> None:
        with self._lock:
            if urls != self._urls:
                self._urls = list(urls)
                self._cycle = itertools.cycle(self._urls)

    def select_replica(self, request: Optional[dict] = None,
                       exclude: Optional[Collection[str]] = None
                       ) -> Optional[str]:
        del request
        excl = exclude or ()
        with self._lock:
            if not self._urls:
                return None
            # One full rotation at most: everything excluded -> None.
            for _ in range(len(self._urls)):
                url = next(self._cycle)
                if url not in excl:
                    return url
            return None

    def ready_replicas(self) -> List[str]:
        with self._lock:
            return list(self._urls)


class PrefixAffinityPolicy(LoadBalancingPolicy):
    """Consistent-hash routing on the request's leading prompt chunk.

    Requests that share a prompt prefix (same system prompt / few-shot
    template) hash to the same point on the ring and land on the SAME
    replica — the one whose decode-engine prefix cache already holds
    that prefix's KV chunks, so they prefill warm. The ring carries
    ``VNODES`` virtual nodes per replica: when a replica disappears,
    only ITS arc of the key space remaps (spread across the survivors),
    and the rest of the traffic keeps its warm affinity — the property
    a modulo hash loses on every membership change.

    Affinity is BOUNDED-LOAD (consistent hashing with bounded loads):
    a prefix's owner takes traffic only while its in-flight count stays
    under ``LOAD_FACTOR`` x the fleet average — beyond that, the
    request walks the ring to the next replica under the bound. One
    dominant system prompt therefore spills to its ring successors
    (which then warm their own caches for it) instead of pinning the
    whole service's traffic on one replica while the rest idle.

    Requests without a hashable prompt (non-/generate paths, opaque
    bodies) fall back to the LEAST-LOADED replica by in-flight count,
    so health probes and admin traffic never pile onto one hash bucket.
    """

    VNODES = 50
    LOAD_FACTOR = 2.0

    def __init__(self, chunk_tokens: int = 64):
        # Affinity key = the first ``chunk_tokens`` prompt ids — the
        # engine's prefill-chunk granularity: a shorter shared prefix
        # wouldn't populate the replica cache anyway.
        self._chunk = int(chunk_tokens)
        self._lock = threading.Lock()
        self._urls: List[str] = []
        self._ring: List[tuple] = []        # sorted (hash, url)
        self._inflight: Dict[str, int] = {}

    @staticmethod
    def _hash(data: bytes) -> int:
        return int.from_bytes(hashlib.md5(data).digest()[:8], "big")

    def set_ready_replicas(self, urls: List[str]) -> None:
        with self._lock:
            if urls == self._urls:
                return
            self._urls = list(urls)
            self._ring = sorted(
                (self._hash(f"{url}#{v}".encode()), url)
                for url in self._urls for v in range(self.VNODES))
            self._inflight = {u: self._inflight.get(u, 0)
                              for u in self._urls}

    def _affinity_key(self, request: Optional[dict]) -> Optional[bytes]:
        """The leading prompt chunk as stable bytes, or None when the
        request carries no parseable prompt (-> least-loaded)."""
        if not request or not request.get("body"):
            return None
        try:
            payload = json.loads(request["body"])
            prompt = payload["prompt"]
            head = [int(t) for t in prompt[:self._chunk]]
        except (ValueError, TypeError, KeyError):
            return None
        if not head:
            return None
        return json.dumps(head).encode()

    def select_replica(self, request: Optional[dict] = None,
                       exclude: Optional[Collection[str]] = None
                       ) -> Optional[str]:
        key = self._affinity_key(request)
        excl = frozenset(exclude or ())
        with self._lock:
            candidates = [u for u in self._urls if u not in excl]
            if not candidates:
                return None
            if key is None:
                url = min(candidates,
                          key=lambda u: self._inflight.get(u, 0))
            else:
                url = self._bounded_ring_walk(key, excl)
            self._inflight[url] = self._inflight.get(url, 0) + 1
            return url

    def _bounded_ring_walk(self, key: bytes,
                           excl: frozenset = frozenset()) -> str:
        """Ring owner for ``key``, spilling to successors while the
        candidate is over the bounded-load threshold (or excluded by
        the caller — a failed/ejected owner spills exactly like a
        saturated one, so retries keep deterministic affinity).
        Deterministic: the same key under the same load always spills
        to the same successor, so the spill target warms too."""
        live = sum(1 for u in self._urls if u not in excl)
        bound = max(2.0, self.LOAD_FACTOR *
                    (sum(self._inflight.values()) + 1) /
                    max(live, 1))
        idx = bisect.bisect_left(self._ring, (self._hash(key), ""))
        seen = set()
        fallback = None
        for step in range(len(self._ring)):
            url = self._ring[(idx + step) % len(self._ring)][1]
            if url in excl or url in seen:
                continue
            if fallback is None:
                fallback = url                 # the true owner
            if self._inflight.get(url, 0) < bound:
                return url
            seen.add(url)
            if len(seen) == live:
                break
        return fallback                        # everyone saturated

    def report_done(self, url: str) -> None:
        with self._lock:
            if url in self._inflight:
                self._inflight[url] = max(self._inflight[url] - 1, 0)

    def ready_replicas(self) -> List[str]:
        with self._lock:
            return list(self._urls)


# Names accepted by --lb-policy / service.load_balancing_policy.
POLICIES = {
    "round_robin": RoundRobinPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}
DEFAULT_POLICY = "round_robin"


def make_policy(name: Optional[str]) -> LoadBalancingPolicy:
    cls = POLICIES.get(name or DEFAULT_POLICY)
    if cls is None:
        raise ValueError(
            f"unknown load-balancing policy {name!r}; expected one of "
            f"{sorted(POLICIES)}")
    return cls()
