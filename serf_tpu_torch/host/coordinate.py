"""Vivaldi network coordinates (host plane).

The port's copy of ``serf_tpu/host/coordinate.py``:
the same names, math and bytes.

Upstream: serf-core/src/types/coordinate.rs (1282 LoC; SURVEY.md §2.5) —
Vivaldi [Dabek et al. 2004] with the Network-Coordinates-in-the-Wild
refinements [Ledlie 2007]: height vectors, error-weighted spring relaxation,
median latency filtering, rolling adjustment term, and gravity re-centering.

The same math vectorizes on the device plane (``serf_tpu_torch.models.vivaldi``)
as N×8 arrays; this scalar version is the parity oracle and serves the host
Serf's ping integration.
"""

from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

from serf_tpu_torch import codec

SECONDS_TO_NS = 1.0e9


@dataclass(frozen=True)
class CoordinateOptions:
    """Defaults match the reference (coordinate.rs:52-204)."""

    dimensionality: int = 8
    vivaldi_error_max: float = 1.5
    vivaldi_ce: float = 0.25
    vivaldi_cc: float = 0.25
    adjustment_window_size: int = 20
    height_min: float = 10.0e-6
    latency_filter_size: int = 3
    gravity_rho: float = 150.0


@dataclass(frozen=True)
class Coordinate:
    """A point in the latency space; distances estimate RTT in seconds."""

    portion: tuple = ()
    error: float = 1.5
    adjustment: float = 0.0
    height: float = 10.0e-6

    @classmethod
    def new(cls, opts: CoordinateOptions) -> "Coordinate":
        return cls(
            portion=(0.0,) * opts.dimensionality,
            error=opts.vivaldi_error_max,
            adjustment=0.0,
            height=opts.height_min,
        )

    def is_valid(self) -> bool:
        return all(math.isfinite(p) for p in self.portion) and \
            math.isfinite(self.error) and math.isfinite(self.adjustment) and \
            math.isfinite(self.height)

    def is_compatible_with(self, other: "Coordinate") -> bool:
        return len(self.portion) == len(other.portion)

    def distance_to(self, other: "Coordinate") -> float:
        """Estimated RTT in seconds: euclidean + heights + adjustments
        (floored at zero before adjustment re-add, per the reference)."""
        dist = _magnitude(_diff(self.portion, other.portion)) + self.height + other.height
        adjusted = dist + self.adjustment + other.adjustment
        return adjusted if adjusted > 0.0 else dist

    def raw_distance_to(self, other: "Coordinate") -> float:
        return _magnitude(_diff(self.portion, other.portion)) + self.height + other.height

    def apply_force(self, height_min: float, force: float,
                    other: "Coordinate", rng: random.Random) -> "Coordinate":
        """Move along the unit vector away-from/toward ``other`` by ``force``
        (reference coordinate.rs:212-430; random unit vector on coincident
        points so identical coordinates can separate)."""
        unit, mag = _unit_vector(self.portion, other.portion, rng)
        portion = tuple(p + u * force for p, u in zip(self.portion, unit))
        height = self.height
        if mag > 0.0:
            height = max(height_min, (self.height + other.height) * force / mag + self.height)
        return replace(self, portion=portion, height=height)

    # wire format (rides in SWIM ping acks)
    def encode(self) -> bytes:
        out = b"".join(codec.encode_double_field(1, p) for p in self.portion)
        out += codec.encode_double_field(2, self.error)
        out += codec.encode_double_field(3, self.adjustment)
        out += codec.encode_double_field(4, self.height)
        return out

    @classmethod
    def decode(cls, buf: bytes) -> "Coordinate":
        portion: List[float] = []
        error, adjustment, height = 1.5, 0.0, 10.0e-6
        for f, _w, v, _p in codec.iter_fields(buf):
            if f == 1:
                portion.append(codec.read_double(v))
            elif f == 2:
                error = codec.read_double(v)
            elif f == 3:
                adjustment = codec.read_double(v)
            elif f == 4:
                height = codec.read_double(v)
        return cls(tuple(portion), error, adjustment, height)


def _diff(a: Sequence[float], b: Sequence[float]) -> List[float]:
    return [x - y for x, y in zip(a, b)]


def _magnitude(v: Sequence[float]) -> float:
    return math.sqrt(sum(x * x for x in v))


def _unit_vector(a: Sequence[float], b: Sequence[float],
                 rng: random.Random) -> tuple:
    d = _diff(a, b)
    mag = _magnitude(d)
    if mag > 1.0e-9:  # ZERO_THRESHOLD
        return [x / mag for x in d], mag
    # coincident points: random unit vector, zero distance
    d = [rng.random() - 0.5 for _ in a]
    mag = _magnitude(d)
    if mag > 1.0e-9:
        return [x / mag for x in d], 0.0
    unit = [0.0] * len(list(a))
    if unit:
        unit[0] = 1.0
    return unit, 0.0


class CoordinateClient:
    """Per-node coordinate estimator (reference CoordinateClient<I>).

    ``update(peer_id, peer_coord, rtt_seconds)`` runs the median latency
    filter, Vivaldi spring relaxation, adjustment-term update, and gravity,
    returning the new local coordinate.  Invalid results (NaN/Inf) reset the
    client (reset counter tracked, reference coordinate.rs:909-914).
    """

    MAX_RTT = 10.0  # seconds; sanity cap (coordinate.rs:893-897)

    def __init__(self, opts: Optional[CoordinateOptions] = None,
                 rng: Optional[random.Random] = None):
        self.opts = opts or CoordinateOptions()
        self.rng = rng or random.Random()
        self._lock = threading.Lock()
        self.coord = Coordinate.new(self.opts)
        self.origin = Coordinate.new(self.opts)
        self.adjustment_samples: List[float] = [0.0] * self.opts.adjustment_window_size
        self.adjustment_index = 0
        self.latency_filters: Dict[str, List[float]] = {}
        self.resets = 0

    def get_coordinate(self) -> Coordinate:
        with self._lock:
            return self.coord

    def set_coordinate(self, coord: Coordinate) -> None:
        self._check(coord)
        with self._lock:
            self.coord = coord

    def forget_node(self, node_id: str) -> None:
        with self._lock:
            self.latency_filters.pop(node_id, None)

    def stats(self) -> dict:
        return {"resets": self.resets}

    def distance_to(self, other: Coordinate) -> float:
        return self.get_coordinate().distance_to(other)

    def update(self, node_id: str, other: Coordinate, rtt: float) -> Coordinate:
        """Returns the updated local coordinate; raises ValueError on
        incompatible dimensions or insane RTT."""
        self._check(other)
        if not (0.0 < rtt <= self.MAX_RTT):
            raise ValueError(f"round trip time not in valid range: {rtt}")
        with self._lock:
            rtt_f = self._latency_filter(node_id, rtt)
            self._update_vivaldi(other, rtt_f)
            self._update_adjustment(other, rtt_f)
            self._update_gravity()
            if not self.coord.is_valid():
                self.resets += 1
                self.coord = Coordinate.new(self.opts)
            return self.coord

    # internals (reference coordinate.rs:699-762) --------------------------

    def _latency_filter(self, node_id: str, rtt: float) -> float:
        samples = self.latency_filters.setdefault(node_id, [])
        samples.append(rtt)
        if len(samples) > self.opts.latency_filter_size:
            samples.pop(0)
        return sorted(samples)[len(samples) // 2]

    def _update_vivaldi(self, other: Coordinate, rtt: float) -> None:
        rtt = max(rtt, 1.0e-9)
        dist = self.coord.distance_to(other)  # adjustment-inclusive (reference)
        wrongness = abs(dist - rtt) / rtt
        total_error = max(self.coord.error + other.error, 1.0e-9)
        weight = self.coord.error / total_error
        error = self.coord.error * (1.0 - self.opts.vivaldi_ce * weight) \
            + wrongness * self.opts.vivaldi_ce * weight
        error = min(error, self.opts.vivaldi_error_max)
        force = self.opts.vivaldi_cc * weight * (rtt - dist)
        self.coord = replace(
            self.coord.apply_force(self.opts.height_min, force, other, self.rng),
            error=error,
        )

    def _update_adjustment(self, other: Coordinate, rtt: float) -> None:
        if self.opts.adjustment_window_size == 0:
            return
        dist = self.coord.raw_distance_to(other)
        self.adjustment_samples[self.adjustment_index] = rtt - dist
        self.adjustment_index = (self.adjustment_index + 1) % self.opts.adjustment_window_size
        self.coord = replace(
            self.coord,
            adjustment=sum(self.adjustment_samples) / (2.0 * self.opts.adjustment_window_size),
        )

    def _update_gravity(self) -> None:
        dist = self.origin.distance_to(self.coord)  # adjustment-inclusive
        force = -1.0 * (dist / self.opts.gravity_rho) ** 2
        self.coord = self.coord.apply_force(self.opts.height_min, force, self.origin, self.rng)

    def _check(self, coord: Coordinate) -> None:
        if not coord.is_compatible_with(self.coord):
            raise ValueError(
                f"dimensions aren't compatible: {len(coord.portion)} vs "
                f"{len(self.coord.portion)}"
            )
        if not coord.is_valid():
            raise ValueError("coordinate is invalid")
