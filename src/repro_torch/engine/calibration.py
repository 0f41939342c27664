"""Closed-loop policy calibration: fit per-scheme strengths from outcomes.

The policy's payoff model (docs/policy.md) predicts a fractional miss-rate
reduction ``gain = skew x strength[scheme]``, where ``skew`` is a probe
composite and ``strength`` measures how well a scheme converts skew into
locality. PR 1 hard-coded the strengths against benchmarks/speedups.py
geomeans; Faldu et al. ("A Closer Look at Lightweight Graph Reordering")
show such static rankings mispredict across graph families — the paper's
own result (section 5) is that payoff is modulated by structure, not fixed
per scheme. This module closes the loop: every ``PolicyRecord`` (predicted
vs realized gain) becomes a regression sample, and the policy consults the
*fitted* strengths on the next decision.

Model: per scheme, ridge regression of realized gain against skew through
the origin, shrunk toward the static prior when samples are few::

    strength = (sum(skew_i * gain_i) + shrinkage * prior)
               / (sum(skew_i ** 2)  + shrinkage)

With zero observations this is exactly the prior (PR 1 behaviour); as
evidence accumulates the data term dominates. Sums-of-products are the
only state, so calibration is O(1) per observation, mergeable, and
trivially serializable — ``save``/``load`` persist it across sessions.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

# Prior relative strength of each scheme at converting skew into miss
# reduction, calibrated against benchmarks/speedups.py geomeans
# (original = 0 by construction: it moves nothing). "visitsort" is the
# search-family telemetry packing (search/serve.py) — hubsort over
# observed visits; its prior sits at hubsort-like strength.
DEFAULT_PRIORS = {
    "original": 0.0,
    "hubcluster": 0.35,
    "dbg": 0.5,
    "lorder": 0.75,
    "visitsort": 0.5,
}


@dataclasses.dataclass
class SchemeStats:
    """Sufficient statistics for one scheme's strength regression."""

    prior: float
    count: int = 0
    sum_ss: float = 0.0   # sum of skew_i^2
    sum_sg: float = 0.0   # sum of skew_i * gain_i

    def observe(self, skew: float, realized_gain: float) -> None:
        self.count += 1
        self.sum_ss += skew * skew
        self.sum_sg += skew * realized_gain

    def fitted(self, shrinkage: float) -> float:
        """Ridge estimate shrunk toward the prior, clamped to [0, 1]."""
        est = (self.sum_sg + shrinkage * self.prior) / (self.sum_ss + shrinkage)
        return min(max(est, 0.0), 1.0)


class StrengthCalibrator:
    """Accumulates PolicyRecords into fitted per-scheme strengths.

    ``shrinkage`` is the ridge weight on the prior, in units of
    sum-of-squared-skew: with typical skews around 0.5 (skew^2 ~ 0.25),
    the default of 2.0 means ~8 observations pull the estimate halfway
    from the prior to the data.
    """

    def __init__(self, priors: dict[str, float] | None = None,
                 shrinkage: float = 2.0):
        self.shrinkage = float(shrinkage)
        if priors is None:
            priors = DEFAULT_PRIORS
        self._stats = {scheme: SchemeStats(prior)
                       for scheme, prior in priors.items()}
        # calibration v2: per-(family, scheme) sufficient statistics.
        # Faldu et al.'s point — payoff is modulated by graph family —
        # applies *within* the fitted model too: a scheme's realized
        # strength on search graphs (visit-skewed, fixed degree) need not
        # match its strength on analytics graphs. Family fits shrink
        # toward the *global* fit (not the static prior), so a family
        # with no observations inherits everything the global pool knows.
        self._family_stats: dict[tuple[str, str], SchemeStats] = {}

    # ----------------------------------------------------------- observe
    def observe(self, scheme: str, skew: float, realized_gain: float,
                family: str | None = None) -> None:
        if scheme not in self._stats:
            self._stats[scheme] = SchemeStats(prior=0.0)
        self._stats[scheme].observe(float(skew), float(realized_gain))
        if family is not None:
            key = (str(family), scheme)
            if key not in self._family_stats:
                # prior field unused for family stats: fitted() shrinks
                # toward the live global fit instead (see strength())
                self._family_stats[key] = SchemeStats(prior=0.0)
            self._family_stats[key].observe(float(skew),
                                            float(realized_gain))

    def observe_record(self, record) -> bool:
        """Feed one ``PolicyRecord``; returns whether it was usable.

        ``original`` decisions carry no measurement (strength is pinned at
        0), and records without a before-miss-rate have no realized gain.
        """
        decision = record.decision
        if decision.scheme == "original" or record.miss_rate_before <= 0:
            return False
        self.observe(decision.scheme, decision.skew, record.realized_gain,
                     family=getattr(record, "family", None))
        return True

    # ------------------------------------------------------------- query
    def strength(self, scheme: str, family: str | None = None) -> float:
        stats = self._stats.get(scheme)
        if stats is None:
            return 0.0
        if scheme == "original":
            return 0.0
        global_fit = stats.fitted(self.shrinkage)
        if family is None:
            return global_fit
        fs = self._family_stats.get((str(family), scheme))
        if fs is None:
            return global_fit
        # family ridge shrunk toward the *leave-this-family-out* fit:
        # the family's own samples must not appear in its shrinkage
        # target too, or a family holding all the evidence gets shrunk
        # twice. With one family in play this reduces exactly to the
        # global fit; evidence from *other* families moves the target.
        other_ss = max(stats.sum_ss - fs.sum_ss, 0.0)
        other_sg = stats.sum_sg - fs.sum_sg
        prior_fit = ((other_sg + self.shrinkage * stats.prior)
                     / (other_ss + self.shrinkage))
        prior_fit = min(max(prior_fit, 0.0), 1.0)
        est = ((fs.sum_sg + self.shrinkage * prior_fit)
               / (fs.sum_ss + self.shrinkage))
        return min(max(est, 0.0), 1.0)

    def count(self, scheme: str, family: str | None = None) -> int:
        if family is not None:
            fs = self._family_stats.get((str(family), scheme))
            return fs.count if fs else 0
        stats = self._stats.get(scheme)
        return stats.count if stats else 0

    def strengths(self) -> dict[str, float]:
        return {s: self.strength(s) for s in self._stats}

    def as_dict(self) -> dict:
        return {
            "shrinkage": self.shrinkage,
            "schemes": {
                s: {"prior": st.prior, "fitted": self.strength(s),
                    "count": st.count, "sum_ss": st.sum_ss,
                    "sum_sg": st.sum_sg}
                for s, st in self._stats.items()
            },
            "families": {
                f"{fam}/{s}": {"fitted": self.strength(s, family=fam),
                               "count": st.count, "sum_ss": st.sum_ss,
                               "sum_sg": st.sum_sg}
                for (fam, s), st in self._family_stats.items()
            },
        }

    # ----------------------------------------------------------- persist
    def save(self, path) -> pathlib.Path:
        """Write calibration state as JSON so it survives sessions."""
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.as_dict(), indent=1))
        return p

    @classmethod
    def load(cls, path) -> "StrengthCalibrator":
        blob = json.loads(pathlib.Path(path).read_text())
        cal = cls(priors={}, shrinkage=blob["shrinkage"])
        for scheme, st in blob["schemes"].items():
            cal._stats[scheme] = SchemeStats(
                prior=st["prior"], count=st["count"],
                sum_ss=st["sum_ss"], sum_sg=st["sum_sg"])
        # "families" is absent in pre-v2 saves — loads as global-only
        for key, st in blob.get("families", {}).items():
            fam, scheme = key.split("/", 1)
            cal._family_stats[(fam, scheme)] = SchemeStats(
                prior=0.0, count=st["count"],
                sum_ss=st["sum_ss"], sum_sg=st["sum_sg"])
        return cal
