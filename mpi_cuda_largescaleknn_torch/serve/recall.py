"""Recall-SLO approximate tier: per-request recall targets -> cheap plans.

Every PR before this one kept the serving stack exhaustively exact; this
module is the quality-vs-cost axis. A request may carry
``"recall": 0.95`` and the server trades a measured, calibrated epsilon
of recall for throughput by selecting a cheaper execution plan:

- ``skip_rescore`` — one-pass bf16 MXU scoring with the exact-rescore
  pass dropped (ops/distance.py ``score_tile``; only engages at
  D >= ``mxu_min_dim``, below which elementwise-exact IS the fast path);
- ``prune_shrink`` — tighten the traversal's kth-distance early exit so
  border buckets are skipped (ops/tiled.py ``knn_update_tiled``);
- ``visit_frac`` — hard-cap the nearest-first bucket schedule at a
  fraction of its visit steps (the aggressive truncation lever: the
  nearest buckets are walked first, so the cut lands on the candidate
  tail);
- ``route_slack`` — in routed pods, escalate to an unvisited host only
  when its bound beats the kth distance by the slack margin
  (serve/frontend.py ``RoutedPodFanout``), shaving escalation waves;
- ``stream_skip_cold`` — in streaming mode, serve from already
  device-resident slabs and skip cold promotions whose bounds cannot
  beat the plan-scaled kth distance (serve/slabpool.py) — turning
  promotion stalls into recall, a knob no exact system has.

The copy of the JAX package's ``serve/recall.py``. The program-shaped
knobs select a launch plan of their own (the engine keys its plans on
``program_key()``); only the engine ``tiled`` takes them, and the exact
default path is unchanged by them. ``RecallPolicy`` maps a target to the CHEAPEST plan whose
CALIBRATED recall meets it; calibration comes from
``tools/recall_harness.py`` (oracle sampling against the exact engine
per workload shape), whose measured curves also gate the claimed targets
in CI (``serve_smoke.py --recall-bench`` -> ``recall_compare``).

Exact stays the default: no ``recall`` field (or any target >= 1.0)
means ``plan_for`` returns ``None`` and every downstream layer takes the
pre-existing exact code path, bit for bit.
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from dataclasses import asdict, dataclass, replace

from mpi_cuda_largescaleknn_torch.utils.annotations import guarded_by


@dataclass(frozen=True)
class RecallPlan:
    """One approximate execution plan: the knob vector plus its
    calibrated recall. Frozen — a plan is a value; per-request targets
    ride a ``replace(plan, recall_target=...)`` copy so concurrent
    requests can never mutate a shared plan."""

    name: str = "exact"
    #: (a) one-pass bf16 score, exact rescore skipped (D >= mxu_min_dim)
    skip_rescore: bool = False
    #: (b) kth-distance early-exit radius factor, (0, 1]; 1.0 = exact
    prune_shrink: float = 1.0
    #: (b) nearest-first visit-schedule cap, (0, 1]; 1.0 = full schedule
    visit_frac: float = 1.0
    #: (c) routed escalation slack, [0, 1); escalate only when
    #: lb_safe <= kth2 * (1 - route_slack). 0.0 = exact certification
    route_slack: float = 0.0
    #: (d) streaming: serve resident slabs, skip bounds-beaten cold
    #: promotions instead of stalling on them
    stream_skip_cold: bool = False
    #: the SLO that selected this plan (echoed in the response)
    recall_target: float = 1.0
    #: calibrated recall claim (min over calibrated workloads, margin
    #: applied by the harness); gates plan selection AND the CI bench
    recall_estimated: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.prune_shrink <= 1.0:
            raise ValueError(f"prune_shrink in (0, 1], got "
                             f"{self.prune_shrink}")
        if not 0.0 < self.visit_frac <= 1.0:
            raise ValueError(f"visit_frac in (0, 1], got {self.visit_frac}")
        if not 0.0 <= self.route_slack < 1.0:
            raise ValueError(f"route_slack in [0, 1), got "
                             f"{self.route_slack}")
        if not 0.0 < self.recall_estimated <= 1.0:
            raise ValueError(f"recall_estimated in (0, 1], got "
                             f"{self.recall_estimated}")

    @property
    def is_exact(self) -> bool:
        """True iff every knob is inert — the plan cannot change any bit
        of the exact path's answer."""
        return (not self.skip_rescore and self.prune_shrink >= 1.0
                and self.visit_frac >= 1.0 and self.route_slack <= 0.0
                and not self.stream_skip_cold)

    def program_key(self) -> tuple:
        """The knobs that change the launched program: this tuple joins
        the engine's launch-plan keys, so plans never collide."""
        return (bool(self.skip_rescore), float(self.prune_shrink),
                float(self.visit_frac))

    def batch_key(self) -> tuple:
        """Everything that forbids coalescing two requests into one
        engine batch (the batcher's plan-keyed sub-batching): the
        program knobs plus the dispatch-time routing/streaming knobs.
        ``recall_target`` is deliberately absent — two requests on the
        same plan at different targets share every executed bit."""
        return self.program_key() + (float(self.route_slack),
                                     bool(self.stream_skip_cold))

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "RecallPlan":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in obj.items() if k in known})


#: the inert plan — selecting it is equivalent to no plan at all
EXACT_PLAN = RecallPlan()

#: built-in conservative defaults, CHEAPEST FIRST (the policy scans in
#: order and takes the first plan meeting the target). The knob budget
#: is deliberately prune-heavy: shrinking the kth-radius early exit cuts
#: the CERTIFICATION tail (bound-checking buckets that rarely hold a
#: winner — sparse big-box buckets the kth radius sweeps through) while
#: the nearest-first schedule keeps the dense buckets where true
#: neighbors live, so deep shrinks trade far less recall per saved visit
#: than deep visit caps do. The recall_estimated claims are deliberate
#: FLOORS beneath what tools/recall_harness.py measures on the
#: uniform/clustered/sweep workload shapes at the reference fixture
#: (D=3, k=16, bucket_size 64: worst-workload measured recall 0.91 /
#: 0.97 / 0.999 for the three plans below, the worst always uniform),
#: so the claims survive index shapes rougher than the fixture; CI
#: re-measures them end to end (serve_smoke --recall-bench). The floors
#: do NOT survive k far above the reference (k=64 halves approx-fast's
#: uniform recall — a deep heap needs far more of the visit schedule to
#: fill its tail), which is why the table is K-CONDITIONED: servers
#: select ``default_plans_for_k(engine.k)``, and deep-k fixtures get the
#: conservative knob vectors below. For calibrated, fixture-specific
#: claims run tools/recall_harness.py at YOUR fixture's k and load its
#: output via --recall-policy (docs/SERVING.md "Recall-SLO tier",
#: docs/TUNING.md "Recall plans vs k").
DEFAULT_PLANS = (
    RecallPlan(name="approx-fast", skip_rescore=True, prune_shrink=0.10,
               visit_frac=0.25, route_slack=0.30, stream_skip_cold=True,
               recall_estimated=0.85),
    RecallPlan(name="approx-balanced", skip_rescore=True,
               prune_shrink=0.30, visit_frac=0.50, route_slack=0.15,
               stream_skip_cold=True, recall_estimated=0.95),
    RecallPlan(name="approx-near", skip_rescore=True, prune_shrink=0.60,
               visit_frac=0.85, route_slack=0.05, stream_skip_cold=True,
               recall_estimated=0.99),
)

#: deep-k (k >= DEEP_K_THRESHOLD) defaults: the kth distance of a deep
#: heap is far out in the candidate tail, so the same prune/visit cuts
#: that cost ~0.1 recall at k=16 amputate half the true set at k=64+.
#: Every knob here is the shallow table's NEXT step up (approx-fast
#: inherits approx-balanced's knob vector claimed a tier lower, and so
#: on), keeping the same three-target ladder at honest floors. Measured
#: at the reference fixture scaled to k=64: 0.88 / 0.97 / 0.995
#: worst-workload (uniform) — the claims below stay beneath that
DEFAULT_PLANS_DEEP_K = (
    RecallPlan(name="approx-fast", skip_rescore=True, prune_shrink=0.30,
               visit_frac=0.50, route_slack=0.15, stream_skip_cold=True,
               recall_estimated=0.85),
    RecallPlan(name="approx-balanced", skip_rescore=True,
               prune_shrink=0.50, visit_frac=0.70, route_slack=0.10,
               stream_skip_cold=True, recall_estimated=0.95),
    RecallPlan(name="approx-near", skip_rescore=True, prune_shrink=0.75,
               visit_frac=0.92, route_slack=0.03, stream_skip_cold=True,
               recall_estimated=0.99),
)

#: k at which the deep-k table takes over for built-in defaults
DEEP_K_THRESHOLD = 64


def default_plans_for_k(k: int | None) -> tuple:
    """The built-in plan table conditioned on the fixture's k. ``None``
    (k unknown — e.g. a custom query_fn with no engine) stays on the
    shallow table: it only changes which UNCALIBRATED floor applies, and
    the shallow floors are the documented legacy behavior."""
    if k is not None and k >= DEEP_K_THRESHOLD:
        return DEFAULT_PLANS_DEEP_K
    return DEFAULT_PLANS


class RecallPolicy:
    """Target -> plan mapping with selection accounting.

    ``plans`` is an ordered cheapest-first tuple; ``plan_for(target)``
    returns the first plan whose calibrated ``recall_estimated`` meets
    the target (as a copy carrying the request's target), or ``None``
    when the target is absent / >= 1.0 / unmeetable — ``None`` IS the
    exact tier, and callers must treat it as "take the pre-existing
    path". The policy itself is immutable after construction; only the
    selection counters mutate, under ``_lock``.
    """

    def __init__(self, plans=DEFAULT_PLANS, source: str = "builtin"):
        plans = tuple(plans)
        for p in plans:
            if p.is_exact:
                raise ValueError(f"plan {p.name!r} is exact — the exact "
                                 "tier is plan_for()'s None, not a table "
                                 "entry")
        if list(plans) != sorted(plans, key=lambda p: p.recall_estimated):
            raise ValueError("plans must be ordered cheapest "
                             "(lowest recall_estimated) first")
        self.plans = plans
        self.source = source
        self._lock = threading.Lock()
        #: selections per plan name ("exact" = target absent/unmeetable)
        self.selected: guarded_by("_lock") = Counter()

    def plan_for(self, target: float | None) -> RecallPlan | None:
        if target is not None and not 0.0 < target <= 1.0:
            raise ValueError(f"recall target must be in (0, 1], "
                             f"got {target}")
        chosen = None
        if target is not None and target < 1.0:
            for plan in self.plans:
                if plan.recall_estimated >= target:
                    chosen = replace(plan, recall_target=float(target))
                    break
        with self._lock:
            self.selected[chosen.name if chosen else "exact"] += 1
        return chosen

    def stats(self) -> dict:
        with self._lock:
            selected = dict(self.selected)
        return {
            "source": self.source,
            "plans": [{"name": p.name,
                       "recall_estimated": p.recall_estimated,
                       "skip_rescore": p.skip_rescore,
                       "prune_shrink": p.prune_shrink,
                       "visit_frac": p.visit_frac,
                       "route_slack": p.route_slack,
                       "stream_skip_cold": p.stream_skip_cold}
                      for p in self.plans],
            "selected": selected,
        }

    # ------------------------------------------------------------- loading

    @classmethod
    def from_dict(cls, obj: dict, source: str = "dict") -> "RecallPolicy":
        """Load a calibration table (tools/recall_harness.py output or a
        hand-written equivalent): ``{"plans": [{...knobs...,
        "recall_estimated": r}, ...]}``. Plans are re-sorted cheapest
        first so a harness sweep can be dumped in any order."""
        plans = [RecallPlan.from_json(p) for p in obj.get("plans", [])]
        plans.sort(key=lambda p: p.recall_estimated)
        return cls(tuple(plans), source=source)

    @classmethod
    def from_file(cls, path: str) -> "RecallPolicy":
        with open(path) as f:
            return cls.from_dict(json.load(f), source=path)

    @classmethod
    def for_k(cls, k: int | None) -> "RecallPolicy":
        """Built-in defaults conditioned on the served fixture's k —
        what the servers construct when no --recall-policy table is
        loaded. Deep k (>= DEEP_K_THRESHOLD) switches to the
        conservative knob ladder; see DEFAULT_PLANS_DEEP_K."""
        deep = k is not None and k >= DEEP_K_THRESHOLD
        return cls(default_plans_for_k(k),
                   source="builtin:deep-k" if deep else "builtin")


def measured_recall(approx_idx, exact_idx) -> float:
    """Mean per-query recall of an approximate id matrix against the
    exact one: |approx ∩ exact| / k averaged over rows. The one recall
    definition shared by the harness, the bench, and the tests (numpy
    arrays [n, k]; -1 pad ids in the approximate rows never match)."""
    import numpy as np

    a = np.asarray(approx_idx)
    e = np.asarray(exact_idx)
    if a.shape != e.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {e.shape}")
    n, k = a.shape
    hits = 0
    for i in range(n):
        hits += len(set(a[i].tolist()) & set(e[i].tolist()))
    return hits / float(n * k) if n and k else 1.0
