"""Elastic placement engine: mutable cluster view + degraded-topology planning.

The port of ``repro.fabric.placement`` (numpy only; every integer output
equals the reference's). ``rs_parity_homes`` belongs to the RS tier,
ROADMAP item 13, and is not ported yet.

The first fabric wired placement once, at construction: ``block_device_homes``
gave each block a permanent primary home, replicas were ring-shifted a fixed
domain over, and parity stripes were cut over the full topology. That wiring
assumes a failed domain comes back — a second hit on the same degraded
topology finds its replicas and parity homes dead and falls through to the
expensive RUNNING_CKPT/DISK tiers. This module makes placement *elastic*:

- :class:`ClusterView` — the mutable source of truth: which devices are
  alive and where every block currently lives (``homes``). Every fabric
  component reads placement through the view instead of private home arrays,
  so one re-plan is visible everywhere at once.
- :func:`rehome_blocks` — after a domain loss, displaced blocks move onto
  surviving devices, least-loaded first (capacity balanced).
- :func:`anti_affine_replica_homes` — replica homes recomputed in the
  *degraded* topology: a different rack when one survives, else a different
  host, else a different device.
- :func:`stripe_parity_groups` / :func:`parity_group_homes` — parity groups
  re-cut over the surviving hosts so every group keeps host-disjoint members
  and a live parity home; a lone tail member folds into the previous group
  so no group ever has fewer than two members.
- :func:`rebalance_homes` — after a domain heals, load is levelled back onto
  the re-admitted devices.

All placement decisions are deterministic (ties break by lowest device id),
so a re-planned cluster is reproducible across runs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fabric.domains import FailureDomainMap


class ClusterView:
    """Mutable cluster state: device liveness + current block placement.

    ``alive`` is the per-device liveness mask over ``domains``; ``homes`` is
    the (total_blocks,) primary home of each block — *current*, not initial:
    :func:`rehome_blocks` rewrites it in place after a failure. ``version``
    increments on every mutation so consumers can detect a stale plan.
    """

    def __init__(self, domains: FailureDomainMap, homes: np.ndarray):
        self.domains = domains
        self.alive = np.ones((domains.n_devices,), bool)
        self.homes = np.array(homes, np.int32, copy=True)
        self.version = 0

    # -- topology over the living ---------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.domains.n_devices

    @property
    def n_alive_devices(self) -> int:
        return int(self.alive.sum())

    def alive_devices(self) -> np.ndarray:
        return np.nonzero(self.alive)[0].astype(np.int32)

    def dead_devices(self) -> np.ndarray:
        return np.nonzero(~self.alive)[0].astype(np.int32)

    def alive_hosts(self) -> np.ndarray:
        """Host ids with at least one alive device."""
        return np.unique(self.domains.host_of(self.alive_devices()))

    @property
    def n_alive_hosts(self) -> int:
        return int(self.alive_hosts().size)

    @property
    def n_alive_racks(self) -> int:
        return int(np.unique(
            self.domains.rack_of(self.alive_devices())).size)

    def host_of(self, device):
        return self.domains.host_of(device)

    def rack_of(self, device):
        return self.domains.rack_of(device)

    # -- mutation -------------------------------------------------------------

    def mark_failed(self, devices) -> np.ndarray:
        """Mark devices dead; returns the ones that were alive before."""
        devices = np.asarray(devices, np.int32).ravel()
        newly = devices[self.alive[devices]]
        if newly.size:
            self.alive[newly] = False
            self.version += 1
        return newly

    def heal(self, devices) -> np.ndarray:
        """Re-admit devices to the view; returns the ones that were dead."""
        devices = np.asarray(devices, np.int32).ravel()
        healed = devices[~self.alive[devices]]
        if healed.size:
            self.alive[healed] = True
            self.version += 1
        return healed

    # -- placement introspection ----------------------------------------------

    def load(self) -> np.ndarray:
        """(n_devices,) block count homed per device."""
        return np.bincount(self.homes, minlength=self.n_devices)

    def displaced_blocks(self) -> np.ndarray:
        """Block ids currently homed on a dead device."""
        return np.nonzero(~self.alive[self.homes])[0].astype(np.int32)


def _pick_balanced(cands: np.ndarray, load: np.ndarray) -> int:
    """Least-loaded candidate; ties break by lowest device id."""
    d = int(cands[np.argmin(load[cands])])
    load[d] += 1
    return d


# ---------------------------------------------------------------------------
# Primary re-homing
# ---------------------------------------------------------------------------

def rehome_blocks(view: ClusterView) -> np.ndarray:
    """Move every block homed on a dead device onto a surviving one,
    least-loaded first. Mutates ``view.homes``; returns the moved block ids.
    """
    displaced = view.displaced_blocks()
    if displaced.size == 0:
        return displaced
    alive = view.alive_devices()
    if alive.size == 0:
        raise RuntimeError("cannot re-home: no surviving devices")
    load = np.bincount(view.homes[view.alive[view.homes]],
                       minlength=view.n_devices)
    for b in displaced:
        view.homes[b] = _pick_balanced(alive, load)
    view.version += 1
    return displaced


def rebalance_homes(view: ClusterView) -> np.ndarray:
    """Level block load across the alive devices (post-heal): move blocks
    off the most-loaded device onto the least-loaded until the spread is
    ≤ 1 block. Returns the moved block ids."""
    alive = view.alive_devices()
    if alive.size <= 1:
        return np.empty((0,), np.int32)
    load = view.load()
    moved: list[int] = []
    while True:
        hi = int(alive[np.argmax(load[alive])])
        lo = int(alive[np.argmin(load[alive])])
        if load[hi] - load[lo] <= 1:
            break
        b = int(np.nonzero(view.homes == hi)[0][0])
        view.homes[b] = lo
        load[hi] -= 1
        load[lo] += 1
        moved.append(b)
    if moved:
        view.version += 1
    return np.asarray(moved, np.int32)


# ---------------------------------------------------------------------------
# Replica re-seeding
# ---------------------------------------------------------------------------

def anti_affine_replica_homes(view: ClusterView) -> np.ndarray:
    """Replica home per block, anti-affine in the *current* (possibly
    degraded) topology: an alive device in a different rack when one
    survives, else on a different host, else a different device, always
    least-loaded first. Falls back to sharing the primary's device only
    when it is the sole survivor."""
    alive = view.alive_devices()
    if alive.size == 0:
        raise RuntimeError("cannot place replicas: no surviving devices")
    a_hosts = np.asarray(view.host_of(alive))
    a_racks = np.asarray(view.rack_of(alive))
    # replica load starts at the primary load so devices packed with
    # primaries attract fewer replicas
    load = view.load().astype(np.int64)
    out = np.empty_like(view.homes)
    for b, p in enumerate(view.homes):
        for cands in (alive[a_racks != int(view.rack_of(p))],
                      alive[a_hosts != int(view.host_of(p))],
                      alive[alive != p],
                      alive):
            if cands.size:
                out[b] = _pick_balanced(cands, load)
                break
    return out


def checkpoint_cache_homes(view: ClusterView,
                           replica_homes: np.ndarray | None = None,
                           ) -> np.ndarray:
    """Running-checkpoint cache home per block: an alive device on a host
    holding neither the primary nor (when possible) the replica, so one
    domain loss cannot take a block, its replica, and its checkpoint copy
    all at once."""
    alive = view.alive_devices()
    if alive.size == 0:
        raise RuntimeError("cannot place checkpoint cache: no devices")
    a_hosts = np.asarray(view.host_of(alive))
    load = view.load().astype(np.int64)
    out = np.empty_like(view.homes)
    for b, p in enumerate(view.homes):
        p_host = int(view.host_of(p))
        tiers = []
        if replica_homes is not None:
            r_host = int(view.host_of(replica_homes[b]))
            tiers.append(alive[(a_hosts != p_host) & (a_hosts != r_host)])
        tiers += [alive[a_hosts != p_host], alive[alive != p], alive]
        for cands in tiers:
            if cands.size:
                out[b] = _pick_balanced(cands, load)
                break
    return out


# ---------------------------------------------------------------------------
# Parity re-striping
# ---------------------------------------------------------------------------

def effective_parity_group(view: ClusterView, group_size: int,
                           reserve: int = 1) -> int:
    """RAID-style width clamp in the current topology: members + parity must
    fit in the alive host count, else a single host failure can erase two
    stripe units and the single-erasure code cannot recover. Leaves
    ``reserve`` hosts free for the parity rows (1 for the XOR codec, m for
    RS(k, m) — each row wants its own member-free host so one host loss
    never takes a member *and* the row that would recover it) whenever
    enough hosts survive to keep ≥ 2 members."""
    if view.n_alive_hosts >= reserve + 2:
        return min(group_size, view.n_alive_hosts - reserve)
    if view.n_alive_hosts >= 3:
        return min(group_size, view.n_alive_hosts - 1)
    return group_size


def stripe_parity_groups(view: ClusterView, group_size: int,
                         fold_tail: bool = True) -> np.ndarray:
    """(n_groups, width) int32 member block ids, -1 padded, striped over the
    *current* placement.

    Each group draws one member from each of the ``group_size`` *fullest*
    per-host block buckets (ties break by lowest host id), so groups stay
    host-disjoint — and a single host failure erases at most one member —
    whenever the load spread allows it at all. Byte-balanced primary
    placement can pack far more blocks onto one host than the others
    (many small leaves land together); plain round-robin interleaving
    leaves that host's surplus as a same-host tail whose groups a single
    host loss wipes entirely, while greedy max-first pairing defers the
    same-host groups to the true pigeonhole residue
    (``2·max_host_load − total`` at width 2). Whatever residue remains is
    chunked same-host as a last resort — the planner's fallback
    accounting prices what those groups cannot cover, never silently.

    A lone tail member is folded into the previous group (widening it by
    one) so every group has ≥ 2 members — a one-member group would make
    the parity a bare copy pinned to a single surviving frame. The RS
    codec passes ``fold_tail=False``: with m ≥ 2 rows a singleton group
    already has host-disjoint copies, and widening a group past the
    clamp can push members + rows over the alive-host count, re-opening
    the double-loss hole the clamp closed.
    """
    hosts = np.asarray(view.host_of(view.homes))
    buckets = {int(h): list(np.nonzero(hosts == h)[0])
               for h in np.unique(hosts)}
    groups: list[list[int]] = []
    while buckets:
        heads = sorted(buckets, key=lambda h: (-len(buckets[h]), h))
        if len(heads) == 1:
            # single host left: chunk its surplus into same-host groups
            tail = buckets.pop(heads[0])
            groups.extend([int(b) for b in tail[i:i + group_size]]
                          for i in range(0, len(tail), group_size))
            break
        grp: list[int] = []
        for h in heads[:group_size]:
            grp.append(int(buckets[h].pop(0)))
            if not buckets[h]:
                del buckets[h]
        groups.append(grp)
    if fold_tail and len(groups) > 1 and len(groups[-1]) == 1:
        groups[-2].extend(groups.pop())
    width = max(group_size, max(len(g) for g in groups))
    members = np.full((len(groups), width), -1, np.int32)
    for j, grp in enumerate(groups):
        members[j, :len(grp)] = grp
    return members


def parity_group_homes(members: np.ndarray, view: ClusterView) -> np.ndarray:
    """Parity block home per group: an alive device whose host holds no
    member, least-loaded first; falls back to an alive device holding no
    member, then any alive device (single-host degenerate topology)."""
    alive = view.alive_devices()
    if alive.size == 0:
        raise RuntimeError("cannot place parity: no surviving devices")
    a_hosts = np.asarray(view.host_of(alive))
    load = view.load().astype(np.int64)
    out = np.zeros((members.shape[0],), np.int32)
    for j, row in enumerate(members):
        ids = row[row >= 0]
        m_hosts = set(np.asarray(view.host_of(view.homes[ids])).ravel()
                      .tolist())
        m_devs = set(int(d) for d in view.homes[ids])
        host_free = alive[~np.isin(a_hosts, list(m_hosts))]
        dev_free = alive[~np.isin(alive, list(m_devs))]
        for cands in (host_free, dev_free, alive):
            if cands.size:
                out[j] = _pick_balanced(cands, load)
                break
    return out
