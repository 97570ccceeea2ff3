"""Quartz-layout cron schedules (counterpart of the cron part of
siddhi_tpu/core/trigger.py: `_parse_field` and `CronSchedule`).

Cron expressions use quartz's 6/7-field layout (sec min hour dom mon dow
[year]), evaluated by the pure-Python matcher below in the host's local
time (`datetime.fromtimestamp`), as the JAX package evaluates them. The
cron window (ops/windows_extra.py) reads its fire instants from here;
trigger definitions are not yet ported.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta
from typing import Optional

from ..errors import SiddhiAppCreationError


def _parse_field(spec: str, lo: int, hi: int,
                 names: Optional[dict] = None) -> Optional[frozenset]:
    """One cron field → allowed-value set, or None for 'any' (* or ?)."""
    spec = spec.strip()
    if spec in ("*", "?"):
        return None
    allowed: set[int] = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if part in ("*", ""):
                part = f"{lo}-{hi}"
        if names:
            for nm, v in names.items():
                part = part.upper().replace(nm, str(v))
        if "-" in part:
            a, b = int(part.split("-", 1)[0]), int(part.split("-", 1)[1])
            if a <= b:
                rng = list(range(a, b + 1, step))
            else:  # quartz wrap-around range, e.g. hours 22-2 or SAT-SUN
                rng = list(range(a, hi + 1, step)) + list(range(lo, b + 1, step))
        else:
            start = int(part)
            rng = range(start, hi + 1, step) if step > 1 else (start,)
        for v in rng:
            if not (lo <= v <= hi):
                raise SiddhiAppCreationError(
                    f"cron field value {v} outside [{lo},{hi}]")
            allowed.add(v)
    if not allowed:
        raise SiddhiAppCreationError(f"cron field {spec!r} matches no values")
    return frozenset(allowed)


_MONTHS = {m.upper(): i for i, m in enumerate(calendar.month_abbr) if m}
_DOWS = {"SUN": 1, "MON": 2, "TUE": 3, "WED": 4, "THU": 5, "FRI": 6, "SAT": 7}


class CronSchedule:
    """Quartz layout: sec min hour day-of-month month day-of-week [year].
    Reference: CronTrigger.java:46 delegates to quartz; this is a direct
    next-fire evaluator over the same field semantics."""

    def __init__(self, expr: str) -> None:
        fields = expr.split()
        if len(fields) not in (6, 7):
            raise SiddhiAppCreationError(
                f"cron expression needs 6 or 7 fields (quartz), got {expr!r}")
        self.sec = _parse_field(fields[0], 0, 59)
        self.minute = _parse_field(fields[1], 0, 59)
        self.hour = _parse_field(fields[2], 0, 23)
        self.dom = _parse_field(fields[3], 1, 31)
        self.mon = _parse_field(fields[4], 1, 12, _MONTHS)
        self.dow = _parse_field(fields[5], 1, 7, _DOWS)  # 1 = SUN (quartz)
        self.year = _parse_field(fields[6], 1970, 2199) if len(fields) == 7 else None
        if self.dom is not None and self.dow is not None:
            # quartz rejects restricting both; accepting would silently AND
            # them (classic cron ORs) — surprising either way
            raise SiddhiAppCreationError(
                "cron: specify day-of-month or day-of-week, not both "
                f"(use '?' for one): {expr!r}")

    @staticmethod
    def _next_in(allowed: Optional[frozenset], v: int, lo: int, hi: int):
        """Smallest allowed value >= v, or (lo-of-allowed, carry=True)."""
        if allowed is None:
            return v, False
        geq = [a for a in allowed if a >= v]
        if geq:
            return min(geq), False
        return min(allowed), True

    def next_fire_ms(self, after_ms: int) -> Optional[int]:
        """First fire time strictly after `after_ms` (epoch millis), read
        in local wall time. Inside a repeated (fall-back) hour the answer
        is the wall time's first occurrence, which may lie before
        `after_ms`: the JAX package's fault, kept for parity."""
        dt = datetime.fromtimestamp(after_ms / 1000.0).replace(microsecond=0)
        nxt = self.next_fire_local(dt + timedelta(seconds=1))
        return None if nxt is None else int(nxt.timestamp() * 1000)

    def next_fire_local(self, dt: datetime) -> Optional[datetime]:
        """The first allowed local wall time at or after the naive `dt`
        (whole seconds, fold 0), within four years. Field-carry evaluation:
        jumps straight to the next allowed second/minute/hour/day instead
        of scanning second-by-second."""
        limit = dt + timedelta(days=366 * 4)
        while dt < limit:
            if ((self.mon is not None and dt.month not in self.mon)
                    or (self.dom is not None and dt.day not in self.dom)
                    or (self.dow is not None
                        and (dt.isoweekday() % 7) + 1 not in self.dow)
                    or (self.year is not None and dt.year not in self.year)):
                dt = (dt + timedelta(days=1)).replace(hour=0, minute=0, second=0)
                continue
            h, carry = self._next_in(self.hour, dt.hour, 0, 23)
            if carry:
                dt = (dt + timedelta(days=1)).replace(hour=0, minute=0, second=0)
                continue
            if h != dt.hour:
                dt = dt.replace(hour=h, minute=0, second=0)
            m, carry = self._next_in(self.minute, dt.minute, 0, 59)
            if carry:
                dt = (dt.replace(minute=0, second=0) + timedelta(hours=1))
                continue
            if m != dt.minute:
                dt = dt.replace(minute=m, second=0)
            s, carry = self._next_in(self.sec, dt.second, 0, 59)
            if carry:
                dt = (dt.replace(second=0) + timedelta(minutes=1))
                continue
            return dt.replace(second=s)
        return None
