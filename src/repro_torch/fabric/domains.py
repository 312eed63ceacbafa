"""Failure domains: device → host → rack topology + correlated sampling.

The port of ``repro.fabric.domains`` (numpy only, so both packages draw
the same domain failures and traces from one ``np.random.Generator``
seed).

The paper (Thm 4.2) models blocks lost *uniformly at random*. Real clusters
lose whole failure domains: a host reboot takes all its devices, a rack
power event takes all its hosts. ``FailureDomainMap`` is the static
description of that hierarchy; correlated failures are sampled as whole
domains, and an MTBF-driven trace generator produces realistic multi-event
schedules for long runs. The paper's uniform model stays available in
:func:`repro_torch.core.recovery.sample_failure_mask` — both plug into the same
tier planner.

Devices are numbered densely; host/rack membership is by contiguous ranges
(device d lives on host d // devices_per_host, etc.), which matches how
data-axis slices map onto physical hosts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

DOMAIN_KINDS = ("device", "host", "rack")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One correlated failure in a sampled trace."""
    step: int
    kind: str       # "device" | "host" | "rack"
    index: int      # domain index of that kind


@dataclasses.dataclass(frozen=True)
class FailureDomainMap:
    n_devices: int
    devices_per_host: int = 4
    hosts_per_rack: int = 2

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.devices_per_host < 1 or self.hosts_per_rack < 1:
            raise ValueError("domain sizes must be >= 1")

    # -- topology ------------------------------------------------------------

    @property
    def n_hosts(self) -> int:
        return math.ceil(self.n_devices / self.devices_per_host)

    @property
    def n_racks(self) -> int:
        return math.ceil(self.n_hosts / self.hosts_per_rack)

    def host_of(self, device):
        """Host index of a device (scalar or ndarray)."""
        return np.asarray(device) // self.devices_per_host

    def rack_of(self, device):
        return self.host_of(device) // self.hosts_per_rack

    def n_domains(self, kind: str) -> int:
        if kind == "device":
            return self.n_devices
        if kind == "host":
            return self.n_hosts
        if kind == "rack":
            return self.n_racks
        raise ValueError(f"unknown domain kind {kind!r}")

    def devices_in(self, kind: str, index: int) -> np.ndarray:
        """All device ids inside one failure domain."""
        if kind == "device":
            lo, hi = index, index + 1
        elif kind == "host":
            lo = index * self.devices_per_host
            hi = lo + self.devices_per_host
        elif kind == "rack":
            lo = index * self.hosts_per_rack * self.devices_per_host
            hi = lo + self.hosts_per_rack * self.devices_per_host
        else:
            raise ValueError(f"unknown domain kind {kind!r}")
        return np.arange(lo, min(hi, self.n_devices), dtype=np.int32)

    # -- correlated sampling -------------------------------------------------

    def sample_domain_failure(self, rng: np.random.Generator,
                              kind: str = "host") -> np.ndarray:
        """Lose one whole domain chosen uniformly: the failed device ids."""
        index = int(rng.integers(self.n_domains(kind)))
        return self.devices_in(kind, index)

    def sample_failure_trace(self, rng: np.random.Generator, n_steps: int,
                             mtbf: dict[str, float]) -> list[FailureEvent]:
        """MTBF-driven trace: per domain kind, exponential inter-arrival
        times with mean ``mtbf[kind]`` (in steps), uniformly-chosen victim.

        Mirrors how real incident logs decompose — independent Poisson
        processes per domain level, rack events far rarer than device ones.
        """
        events: list[FailureEvent] = []
        for kind, mean in mtbf.items():
            if kind not in DOMAIN_KINDS:
                raise ValueError(f"unknown domain kind {kind!r}")
            t = rng.exponential(mean)
            while t < n_steps:
                events.append(FailureEvent(
                    step=int(math.ceil(t)), kind=kind,
                    index=int(rng.integers(self.n_domains(kind)))))
                t += rng.exponential(mean)
        return sorted(events, key=lambda e: e.step)
