"""The unified communication-fabric API (paper §2.3–§4.2).

One abstraction for every rendition of the paper's path model — the TPU
mesh (①/②/③/③* as ICI/DCN/PCIe, core/paths.py), the LineFS §5.1
replication fabric, and the DrTM-KV §5.2 RDMA fabric — instead of three
incompatible ad-hoc copies.

Concepts
--------
``Path``       one directed-capacity resource: bandwidth in *typed*
               units (``bytes/s`` or ``ops/s``), per direction; a
               bidirectional path multiplexes opposite flows (paper
               Fig 5: READ+WRITE ≈ 2x one-way).
``Fabric``     the set of paths plus the fabric-wide §4.1 concurrency
               discount; behaves as a ``Mapping[str, Path]``.
``Use``        traffic one unit of work places on one path (amounts in
               the path's units, per direction).
``Alternative``one way to implement a functionality: a bundle of Uses,
               an optional endpoint compute cap (the "wimpy SoC"
               premise), and ranking criteria.
``BudgetLedger``per-direction budget accounting with reserve / release /
               checkpoint-restore semantics. The §4.1 concurrency
               discount — shared resources lose 7–15% when more than
               one flow is concurrently active on them (or on a path in
               the same ``shared_group``) — is applied *here, once*,
               never at call sites.
``MultipathRouter``the §4.2 guideline, executable: rank alternatives,
               greedily combine them against a ledger until a shared
               resource saturates, blend a fixed mix (e.g. the DrTM-KV
               A4+A5 hit/miss split), and the B_slow <= P − N slack
               rule.

The per-direction budget model reproduces the paper's findings natively:
opposite-direction flows draw from different direction budgets (Fig 5),
and a path that crosses one link twice (paper path-③) consumes both
budgets at once — the "hidden bottleneck".
"""
from __future__ import annotations

import math
import warnings
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

# typed path units
BYTES_PER_S = "bytes/s"
OPS_PER_S = "ops/s"

OUT, IN = "out", "in"
_DIRS = (OUT, IN)

#: path kinds with first-class meaning to the offload tier: a compute
#: resource (host cores / SoC ARM complex) and a DCA-style datapath
#: accelerator ("Demystifying Datapath Accelerator Enhanced Off-path
#: SmartNIC", PAPERS.md) — a fixed-function engine that is neither a
#: wire nor a general core, with its own ops/s budget.
COMPUTE = "compute"
DCA = "dca"


class FabricError(ValueError):
    """Unknown path, unit mismatch, or malformed alternative."""


class InsufficientBudget(RuntimeError):
    """A strict reserve() asked for more than the remaining budget."""


# ----------------------------------------------------------------------
# paths and fabrics
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Path:
    """One communication path. ``capacity`` is per direction, in
    ``units``; ``bidirectional`` means the opposite direction has its
    own equal budget (multiplexing), otherwise the IN budget is 0."""
    name: str
    capacity: float
    units: str = BYTES_PER_S
    latency: float = 0.0               # seconds, one hop
    bidirectional: bool = True
    shared_group: Optional[str] = None # interference group (§4.1)
    kind: str = "generic"              # ici | dcn | pcie | rdma | ...
    axis: Optional[str] = None         # mesh axis (TPU fabrics)
    size: int = 2                      # participants along the path

    def __post_init__(self):
        if self.capacity <= 0:
            raise FabricError(f"path {self.name}: capacity must be > 0")
        if self.units not in (BYTES_PER_S, OPS_PER_S):
            raise FabricError(f"path {self.name}: unknown units {self.units!r}")

    @property
    def bw(self) -> float:
        """Legacy alias for ``capacity`` (bytes/s paths)."""
        return self.capacity

    @property
    def group(self) -> str:
        return self.shared_group or self.name

    def time_for(self, amount: float, *, both_directions: bool = False) -> float:
        """Transfer/service time for `amount` (path units x seconds).
        Opposite-direction traffic multiplexes, so both_directions does
        not slow a bidirectional path down."""
        if amount <= 0:
            return 0.0
        return self.latency + amount / self.capacity

    @property
    def is_compute(self) -> bool:
        """True for compute-tier resources (SoC cores, DCA engines):
        ops/s paths with no opposite direction — work is executed, not
        echoed back."""
        return self.units == OPS_PER_S and not self.bidirectional


def compute_path(name: str, ops_per_s: float, *, latency: float = 0.0,
                 shared_group: Optional[str] = None,
                 kind: str = COMPUTE) -> Path:
    """A compute resource as a fabric Path: ``ops_per_s`` is the
    device's roofline (for byte-granular work like compression, one op
    == one byte processed). Unidirectional — a ``Compute`` reservation
    draws on the OUT budget only — so the same ledger/fair-share/QoS
    machinery that governs wires governs cores."""
    return Path(name, ops_per_s, OPS_PER_S, latency=latency,
                bidirectional=False, shared_group=shared_group, kind=kind)


def dca_path(name: str, ops_per_s: float, *, latency: float = 0.0,
             shared_group: Optional[str] = None) -> Path:
    """A DCA-style datapath-accelerator path (kind=``dca``): the
    fixed-function engine class of "Demystifying Datapath Accelerator
    Enhanced Off-path SmartNIC" — much higher ops/s than the SoC's
    wimpy cores, lower dispatch latency, but only for the operations it
    implements (the caller decides eligibility)."""
    return compute_path(name, ops_per_s, latency=latency,
                        shared_group=shared_group, kind=DCA)


class Fabric(Mapping):
    """A set of named paths + the fabric-wide concurrency discount.

    Mapping protocol gives ``fabric["pcie:host"]``, iteration and
    ``len`` — drop-in for the old ``Dict[str, PathSpec]`` tables.
    """

    def __init__(self, paths: Union[Iterable[Path], Mapping[str, Path]] = (),
                 *, concurrency_discount: float = 0.0):
        if isinstance(paths, Mapping):
            paths = paths.values()
        self._paths: Dict[str, Path] = {}
        for p in paths:
            self.add(p)
        if not 0.0 <= concurrency_discount < 1.0:
            raise FabricError("concurrency_discount must be in [0, 1)")
        self.concurrency_discount = float(concurrency_discount)

    # -- construction ---------------------------------------------------
    @classmethod
    def of(cls, *paths: Path, concurrency_discount: float = 0.0) -> "Fabric":
        return cls(paths, concurrency_discount=concurrency_discount)

    def add(self, path: Path) -> "Fabric":
        if path.name in self._paths:
            raise FabricError(f"duplicate path {path.name}")
        self._paths[path.name] = path
        return self

    # -- Mapping protocol ----------------------------------------------
    def __getitem__(self, name: str) -> Path:
        return self._paths[name]

    def __iter__(self):
        return iter(self._paths)

    def __len__(self) -> int:
        return len(self._paths)

    def __repr__(self) -> str:
        names = ", ".join(self._paths)
        return f"Fabric({names}; discount={self.concurrency_discount})"

    # -- semantics ------------------------------------------------------
    def direction_capacity(self, name: str, direction: str) -> float:
        p = self[name]
        if direction == IN and not p.bidirectional:
            return 0.0
        return p.capacity

    def validate(self, alt: "Alternative") -> None:
        """Check every Use references a known path in matching units."""
        for u in alt.uses:
            if u.path not in self._paths:
                raise FabricError(
                    f"alternative {alt.name}: unknown path {u.path!r} "
                    f"(fabric has {sorted(self._paths)})")
            if u.units is not None and u.units != self[u.path].units:
                raise FabricError(
                    f"alternative {alt.name}: use on {u.path} declared in "
                    f"{u.units} but the path is {self[u.path].units}")

    def ledger(self) -> "BudgetLedger":
        return BudgetLedger(self)

    def router(self) -> "MultipathRouter":
        return MultipathRouter(self)

    # -- composition (multi-tenant fabrics) -----------------------------
    def namespaced(self, prefix: str, *, sep: str = "/") -> "Fabric":
        """A copy with every path (and explicit shared_group) renamed
        ``<prefix><sep><name>`` — so two structurally identical fabrics
        can coexist in one merged fabric without colliding. Implicit
        groups (``shared_group=None``) stay implicit: they follow the
        renamed path automatically."""
        import dataclasses
        renamed = [
            dataclasses.replace(
                p, name=f"{prefix}{sep}{p.name}",
                shared_group=(f"{prefix}{sep}{p.shared_group}"
                              if p.shared_group is not None else None))
            for p in self._paths.values()]
        return Fabric(renamed,
                      concurrency_discount=self.concurrency_discount)


def merge_fabrics(*fabrics: Fabric,
                  concurrency_discount: Optional[float] = None) -> "Fabric":
    """One fabric from many — the multi-tenant substrate: tenants that
    should *share* a path (and its budgets) reference the same path name
    in each input; a duplicate name is tolerated only when the Path
    definitions are identical (then it merges into one shared path), and
    a conflicting redefinition raises. Namespace an input first
    (``Fabric.namespaced``) when its paths must stay private. The merged
    discount defaults to the max of the inputs (the shared medium is at
    least as contended as its worst constituent)."""
    merged: Dict[str, Path] = {}
    for fab in fabrics:
        for p in fab.values():
            have = merged.get(p.name)
            if have is None:
                merged[p.name] = p
            elif have != p:
                raise FabricError(
                    f"merge conflict on path {p.name!r}: {have} != {p}")
    disc = (concurrency_discount if concurrency_discount is not None
            else max((f.concurrency_discount for f in fabrics), default=0.0))
    return Fabric(merged.values(), concurrency_discount=disc)


# ----------------------------------------------------------------------
# work descriptions
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Use:
    """Traffic one unit of work places on one path, per direction, in
    the path's units. ``units`` is an optional declaration checked
    against the path (bytes/s vs ops/s)."""
    path: str
    out: float = 0.0
    in_: float = 0.0
    units: Optional[str] = None

    # legacy field names (planner.PathUse)
    @property
    def out_bytes(self) -> float:
        return self.out

    @property
    def in_bytes(self) -> float:
        return self.in_


@dataclass
class Alternative:
    """One way to implement the functionality (paper Figure 14/16)."""
    name: str
    uses: List[Use]
    compute_rate: float = math.inf     # units of work/s the endpoint sustains
    criteria: Dict[str, float] = field(default_factory=dict)
    # e.g. {"host_cpu": 0.2, "latency_us": 4.6, "net_utilization": 1.0}
    tenant: Optional[str] = None       # QoS tag for weighted allocation

    def solo_rate(self, fabric: Mapping,
                  ledger: Optional["BudgetLedger"] = None) -> float:
        """Peak work units/s using this alternative alone (no sharing,
        no discount — a single flow). With a ``ledger``, the rate is
        computed against the *remaining* budgets (live occupancy,
        discount included via the ledger's holder count)."""
        rate = self.compute_rate
        for u in self.uses:
            if ledger is not None:
                cap_out = ledger.available(u.path, OUT, joining=self.name)
                cap_in = ledger.available(u.path, IN, joining=self.name)
            else:
                cap_out = cap_in = fabric[u.path].capacity
            if u.out > 0:
                rate = min(rate, cap_out / u.out)
            if u.in_ > 0:
                rate = min(rate, cap_in / u.in_)
        return rate


@dataclass
class Allocation:
    alternative: str
    rate: float                        # work units/s granted
    bottleneck: str                    # what stopped further allocation


# ----------------------------------------------------------------------
# the budget ledger
# ----------------------------------------------------------------------

class BudgetLedger:
    """Per-direction budget accounting over a Fabric.

    Every (path, direction) starts with the path's direction capacity.
    Flows reserve rate against it and may release it back. The §4.1
    concurrency discount lives here and only here: a path's *effective*
    capacity drops to ``capacity * (1 - discount)`` while more than one
    distinct flow holds it or any path in its ``shared_group``.

    ``checkpoint()`` / ``restore()`` snapshot the whole ledger, so a
    router can explore an allocation and roll it back.

    Holder accounting is *indexed*: a per-interference-group
    ``flow -> live (flow, path) entry count`` map is maintained on every
    reserve/release, so ``holders()`` (and the runtime's discount check)
    is O(group flows) instead of a scan over every ledger entry — the
    scan was the dominant cost of rebalancing at O(1k) concurrent
    transfers.
    """

    def __init__(self, fabric: Fabric):
        self.fabric = fabric
        # (path, dir) -> total reserved rate (path units)
        self._reserved: Dict[Tuple[str, str], float] = {
            (name, d): 0.0 for name in fabric for d in _DIRS}
        # (flow, path) -> reserved (out, in) — release bookkeeping
        self._by_flow: Dict[Tuple[str, str], Tuple[float, float]] = {}
        # path -> interference group (cached; lazily extended)
        self._group_of: Dict[str, str] = {
            name: fabric[name].group for name in fabric}
        # group -> flow -> number of live (flow, path) entries: the
        # holder index. Every _by_flow entry has a positive component
        # (reserve never creates an all-zero entry; release pops them),
        # so entry count == holder-ship.
        self._holders: Dict[str, Dict[str, int]] = {}

    def _group(self, name: str) -> str:
        g = self._group_of.get(name)
        if g is None:
            g = self._group_of[name] = self.fabric[name].group
        return g

    def _holder_add(self, name: str, flow: str) -> None:
        g = self._group(name)
        d = self._holders.setdefault(g, {})
        d[flow] = d.get(flow, 0) + 1

    def _holder_del(self, name: str, flow: str) -> None:
        g = self._group(name)
        d = self._holders.get(g)
        if d is None:
            return
        c = d.get(flow, 0) - 1
        if c <= 0:
            d.pop(flow, None)
            if not d:
                del self._holders[g]
        else:
            d[flow] = c

    def _rebuild_holders(self) -> None:
        self._holders = {}
        for (flow, name) in self._by_flow:
            self._holder_add(name, flow)

    # -- holders / discount --------------------------------------------
    def holders(self, name: str) -> Set[str]:
        """Distinct flows active on this path's interference group."""
        return set(self._holders.get(self._group(name), ()))

    def group_holders(self, group: str) -> Dict[str, int]:
        """The live ``flow -> entry count`` index for one interference
        group — the O(1)-maintained structure behind ``holders()``; the
        runtime's discount check reads it directly (counting distinct
        flows without building a set)."""
        return self._holders.get(group, {})

    def effective_capacity(self, name: str, direction: str,
                           *, joining: Optional[str] = None) -> float:
        """Direction capacity after the concurrency discount, assuming
        `joining` (if given) becomes an additional holder."""
        base = self.fabric.direction_capacity(name, direction)
        holders = self.holders(name)
        if joining is not None:
            holders = holders | {joining}
        if len(holders) > 1 and self.fabric.concurrency_discount > 0.0:
            base *= 1.0 - self.fabric.concurrency_discount
        return base

    def available(self, name: str, direction: str,
                  *, joining: Optional[str] = None) -> float:
        cap = self.effective_capacity(name, direction, joining=joining)
        return max(0.0, cap - self._reserved[(name, direction)])

    def headroom(self, name: str) -> float:
        """min over directions of what is still free on `name`."""
        return min(self.available(name, OUT), self.available(name, IN))

    # -- reserve / release ---------------------------------------------
    def reserve(self, name: str, *, out: float = 0.0, in_: float = 0.0,
                flow: str = "default", strict: bool = True) -> bool:
        """Reserve rate on a path. Strict mode raises InsufficientBudget
        (and reserves nothing) when a direction would be over-committed;
        non-strict returns False instead."""
        if name not in self.fabric:
            raise FabricError(f"unknown path {name!r}")
        if out < 0 or in_ < 0:
            raise FabricError("reservations must be non-negative")
        if out == 0.0 and in_ == 0.0:
            return True
        eps = 1e-9
        for direction, amt in ((OUT, out), (IN, in_)):
            if amt <= 0:
                continue
            avail = self.available(name, direction, joining=flow)
            if amt > avail * (1 + eps) + eps:
                if strict:
                    raise InsufficientBudget(
                        f"{name}:{direction}: requested {amt:.6g}, "
                        f"available {avail:.6g} (flow={flow})")
                return False
        self._reserved[(name, OUT)] += out
        self._reserved[(name, IN)] += in_
        fkey = (flow, name)
        cur = self._by_flow.get(fkey)
        if cur is None:
            self._by_flow[fkey] = (out, in_)
            self._holder_add(name, flow)
        else:
            self._by_flow[fkey] = (cur[0] + out, cur[1] + in_)
        return True

    def release(self, name: str, *, out: float = 0.0, in_: float = 0.0,
                flow: str = "default") -> None:
        """Release previously reserved rate; releasing more than the
        flow holds is an error (conservation)."""
        po, pi = self._by_flow.get((flow, name), (0.0, 0.0))
        eps = 1e-9 * max(1.0, po, pi)
        if out > po + eps or in_ > pi + eps:
            raise InsufficientBudget(
                f"{name}: flow {flow} releasing ({out:.6g},{in_:.6g}) "
                f"but holds ({po:.6g},{pi:.6g})")
        self._reserved[(name, OUT)] = max(0.0, self._reserved[(name, OUT)] - out)
        self._reserved[(name, IN)] = max(0.0, self._reserved[(name, IN)] - in_)
        no, ni = max(0.0, po - out), max(0.0, pi - in_)
        if no <= 0.0 and ni <= 0.0:
            if self._by_flow.pop((flow, name), None) is not None:
                self._holder_del(name, flow)
        else:
            self._by_flow[(flow, name)] = (no, ni)

    def shift(self, name: str, direction: str, deltas: Dict[str, float]) -> None:
        """Runtime fast path: apply per-flow reservation *deltas* on one
        (path, direction) without the strict availability scan — the
        caller (``FabricRuntime``'s rebalancer) constructs fair shares
        that fit the budget by construction, and has already aggregated
        one delta per flow. Bookkeeping (``_reserved`` clamping,
        ``_by_flow`` entry lifecycle, the holder index) matches a
        reserve()/release() sequence exactly, so conservation
        invariants and ``holders()`` are unaffected."""
        key = (name, direction)
        total = self._reserved[key]
        out_dir = direction == OUT
        for flow, d in deltas.items():
            if d == 0.0:
                continue
            total = total + d if d > 0 else max(0.0, total + d)
            fkey = (flow, name)
            po, pi = self._by_flow.get(fkey, (0.0, 0.0))
            if out_dir:
                po = po + d if d > 0 else max(0.0, po + d)
            else:
                pi = pi + d if d > 0 else max(0.0, pi + d)
            if po <= 0.0 and pi <= 0.0:
                if self._by_flow.pop(fkey, None) is not None:
                    self._holder_del(name, flow)
            elif fkey in self._by_flow:
                self._by_flow[fkey] = (po, pi)
            else:
                self._by_flow[fkey] = (po, pi)
                self._holder_add(name, flow)
        self._reserved[key] = total

    def release_flow(self, flow: str) -> None:
        """Release everything a flow holds, across all paths."""
        for (f, name), (o, i) in list(self._by_flow.items()):
            if f == flow:
                self.release(name, out=o, in_=i, flow=flow)

    def reserve_alternative(self, alt: Alternative, rate: float,
                            *, flow: Optional[str] = None,
                            strict: bool = True) -> bool:
        """Reserve `rate` work units/s worth of an alternative's uses,
        atomically (all uses or none — also when a strict reserve
        raises mid-way)."""
        flow = flow if flow is not None else alt.name
        token = self.checkpoint()
        try:
            for u in alt.uses:
                ok = self.reserve(u.path, out=rate * u.out, in_=rate * u.in_,
                                  flow=flow, strict=strict)
                if not ok:
                    self.restore(token)
                    return False
        except InsufficientBudget:
            self.restore(token)
            raise
        return True

    # -- snapshot -------------------------------------------------------
    def checkpoint(self):
        return dict(self._reserved), dict(self._by_flow)

    def restore(self, token) -> None:
        reserved, by_flow = token
        self._reserved = dict(reserved)
        self._by_flow = dict(by_flow)
        self._rebuild_holders()

    def reserved(self, name: str, direction: str) -> float:
        return self._reserved[(name, direction)]


# ----------------------------------------------------------------------
# the router (§4.2, executable)
# ----------------------------------------------------------------------

class MultipathRouter:
    """Turns Alternatives + a demand/criteria spec into rate allocations."""

    def __init__(self, fabric: Fabric):
        self.fabric = fabric

    # -- step 2: rank ---------------------------------------------------
    def rank(self, alts: Sequence[Alternative], key: str = "rate",
             prefer: Optional[Sequence[str]] = None) -> List[Alternative]:
        """Rank by solo rate (default) or an explicit criterion
        (lower-is-better for latency_us/host_cpu, higher for the rest)."""
        if prefer:
            order = {n: i for i, n in enumerate(prefer)}
            return sorted(alts, key=lambda a: order.get(a.name, len(order)))
        if key == "rate":
            return sorted(alts, key=lambda a: -a.solo_rate(self.fabric))
        sign = 1.0 if key in ("latency_us", "host_cpu") else -1.0
        return sorted(alts, key=lambda a: sign * a.criteria.get(key, math.inf))

    # -- step 3: greedy combine ----------------------------------------
    def allocate(self, alts_ranked: Sequence[Alternative],
                 demand: float = math.inf,
                 *, ledger: Optional[BudgetLedger] = None,
                 qos=None) -> Tuple[List[Allocation], float]:
        """Give each alternative in order as much rate as the remaining
        budgets allow; stop when demand is met or everything saturates.
        Mutates `ledger` if given (so callers can pre-reserve primary
        traffic); returns (allocations, total_rate).

        With ``qos`` (any object exposing ``weight(tenant) -> float``,
        see tenancy/qos.QoSPolicy), the allocation switches from
        in-order greedy to *weighted max-min* over the alternatives'
        ``tenant`` tags — the same progressive-filling split the
        FabricRuntime applies to live transfers, so a static plan and
        the converged runtime shares agree under tenancy (asserted in
        tests/test_offload.py)."""
        led = ledger if ledger is not None else self.fabric.ledger()
        if qos is not None:
            return self._allocate_weighted(alts_ranked, demand, led, qos)
        allocs: List[Allocation] = []
        total = 0.0
        for alt in alts_ranked:
            self.fabric.validate(alt)
            if total >= demand:
                break
            rate = min(alt.compute_rate, demand - total)
            bottleneck = "compute" if rate == alt.compute_rate else "demand"
            demand_per_dir: Dict[Tuple[str, str], float] = {}
            for u in alt.uses:     # aggregate: two Uses of one path add up
                if u.out > 0:
                    demand_per_dir[(u.path, OUT)] = \
                        demand_per_dir.get((u.path, OUT), 0.0) + u.out
                if u.in_ > 0:
                    demand_per_dir[(u.path, IN)] = \
                        demand_per_dir.get((u.path, IN), 0.0) + u.in_
            for (pname, direction), amt in demand_per_dir.items():
                r = led.available(pname, direction, joining=alt.name) / amt
                if r < rate:
                    rate, bottleneck = r, f"{pname}:{direction}"
            if rate <= 0:
                allocs.append(Allocation(alt.name, 0.0, bottleneck))
                continue
            led.reserve_alternative(alt, rate)
            total += rate
            allocs.append(Allocation(alt.name, rate, bottleneck))
        return allocs, total

    def _allocate_weighted(self, alts: Sequence[Alternative], demand: float,
                           led: BudgetLedger, qos,
                           ) -> Tuple[List[Allocation], float]:
        """Progressive filling: every unfrozen alternative's rate rises
        in proportion to its tenant's QoS weight until a shared resource
        saturates (its users freeze with that bottleneck), a compute cap
        binds, or the aggregate demand is met — the static-plan twin of
        ``FabricRuntime._rebalance``'s weighted max-min. The §4.1
        discount applies per interference group iff the group ends up
        with more than one distinct flow (allocated alternatives plus
        live ledger holders), exactly as the runtime counts it."""
        alts = list(alts)
        for alt in alts:
            self.fabric.validate(alt)
            if not alt.uses and not math.isfinite(alt.compute_rate):
                raise FabricError(
                    f"alternative {alt.name} is unbounded: no use and no "
                    "compute cap")
        weights = [float(qos.weight(alt.tenant)) for alt in alts]
        # per-(path, dir) demand of one work unit of each alternative
        unit: List[Dict[Tuple[str, str], float]] = []
        for alt in alts:
            d: Dict[Tuple[str, str], float] = {}
            for u in alt.uses:
                if u.out > 0:
                    d[(u.path, OUT)] = d.get((u.path, OUT), 0.0) + u.out
                if u.in_ > 0:
                    d[(u.path, IN)] = d.get((u.path, IN), 0.0) + u.in_
            unit.append(d)
        # group -> flows that will be on it: allocated alts + ledger holders
        flows_on: Dict[str, Set[str]] = {}
        for alt, d in zip(alts, unit):
            for (pname, _dir) in d:
                flows_on.setdefault(self.fabric[pname].group, set()).add(alt.name)
        avail: Dict[Tuple[str, str], float] = {}
        for d in unit:
            for (pname, direction) in d:
                if (pname, direction) in avail:
                    continue
                cap = self.fabric.direction_capacity(pname, direction)
                group = self.fabric[pname].group
                flows = flows_on.get(group, set()) | led.holders(pname)
                if len(flows) > 1 and self.fabric.concurrency_discount > 0.0:
                    cap *= 1.0 - self.fabric.concurrency_discount
                avail[(pname, direction)] = \
                    max(0.0, cap - led.reserved(pname, direction))
        rates = [0.0] * len(alts)
        bottleneck = [""] * len(alts)
        active = [i for i in range(len(alts)) if weights[i] > 0]
        for i in range(len(alts)):
            if weights[i] <= 0:
                bottleneck[i] = "weight"
        total = 0.0
        eps = 1e-12
        while active:
            # largest uniform step theta: rate_i += theta * w_i for all
            # active i, bounded by every touched resource, each compute
            # cap, and the remaining aggregate demand
            theta = math.inf
            binder: Optional[str] = None
            for (pname, direction), cap_left in avail.items():
                usage = sum(weights[i] * unit[i].get((pname, direction), 0.0)
                            for i in active)
                if usage > eps:
                    t = cap_left / usage
                    if t < theta:
                        theta, binder = t, f"{pname}:{direction}"
            for i in active:
                if math.isfinite(alts[i].compute_rate):
                    t = (alts[i].compute_rate - rates[i]) / weights[i]
                    if t < theta:
                        theta, binder = t, "compute"
            if math.isfinite(demand):
                wsum = sum(weights[i] for i in active)
                t = (demand - total) / wsum if wsum > 0 else 0.0
                if t < theta:
                    theta, binder = t, "demand"
            if not math.isfinite(theta):
                raise FabricError("weighted allocation is unbounded: active "
                                  "alternatives have no binding resource")
            theta = max(theta, 0.0)
            for i in active:
                step = theta * weights[i]
                rates[i] += step
                total += step
                for key, amt in unit[i].items():
                    avail[key] = max(0.0, avail[key] - step * amt)
            # freeze: saturated resources stop their users; compute caps
            # and demand stop whoever they bind
            still = []
            for i in active:
                stop = None
                if binder == "demand":
                    stop = "demand"
                elif binder == "compute" \
                        and rates[i] >= alts[i].compute_rate - eps:
                    stop = "compute"
                else:
                    for key in unit[i]:
                        if avail[key] <= eps:
                            stop = f"{key[0]}:{key[1]}"
                            break
                if stop is None:
                    still.append(i)
                else:
                    bottleneck[i] = stop
            if len(still) == len(active):   # theta made no one freeze
                break
            active = still
        for alt, rate in zip(alts, rates):
            if rate > 0:
                led.reserve_alternative(alt, rate)
        return [Allocation(alt.name, rate, bn)
                for alt, rate, bn in zip(alts, rates, bottleneck)], total

    def route(self, alts: Sequence[Alternative], demand: float = math.inf,
              *, key: str = "rate", prefer: Optional[Sequence[str]] = None,
              ledger: Optional[BudgetLedger] = None,
              ) -> Tuple[List[Allocation], float]:
        """rank + allocate in one call."""
        return self.allocate(self.rank(alts, key=key, prefer=prefer),
                             demand, ledger=ledger)

    # -- fixed-ratio mixing (DrTM-KV A4+A5) ----------------------------
    def blend(self, weighted: Sequence[Tuple[Alternative, float]],
              *, ledger: Optional[BudgetLedger] = None,
              ) -> Tuple[float, List[Allocation]]:
        """Scale a fixed mix of alternatives (weights = fraction of work
        each serves, e.g. cache hit/miss masses) up to the first
        saturated resource. The §4.1 discount applies to every path
        whose interference group is touched by more than one member of
        the mix. With a ``ledger``, the mix is scaled against the
        *remaining* budgets: live holders count toward the discount and
        their reservations shrink the capacity — so re-planning under
        load sees the fabric as it is, not as it was at startup.
        Returns (total work units/s, per-member allocations)."""
        usage: Dict[Tuple[str, str], float] = {}
        touchers: Dict[str, Set[str]] = {}
        total = math.inf
        for alt, w in weighted:
            self.fabric.validate(alt)
            if w < 0:
                raise FabricError(f"negative weight for {alt.name}")
            if w == 0:
                continue            # inactive member: no usage, no discount
            if math.isfinite(alt.compute_rate):
                total = min(total, alt.compute_rate / w)
            for u in alt.uses:
                usage[(u.path, OUT)] = usage.get((u.path, OUT), 0.0) + w * u.out
                usage[(u.path, IN)] = usage.get((u.path, IN), 0.0) + w * u.in_
                group = self.fabric[u.path].group
                touchers.setdefault(group, set()).add(alt.name)
        bottleneck = "compute" if math.isfinite(total) else "unbounded"
        for (name, direction), amt in usage.items():
            if amt <= 0:
                continue
            cap = self.fabric.direction_capacity(name, direction)
            mixers: Set[str] = set(touchers[self.fabric[name].group])
            if ledger is not None:
                mixers |= ledger.holders(name)
            if len(mixers) > 1:
                cap *= 1.0 - self.fabric.concurrency_discount
            if ledger is not None:
                cap = max(0.0, cap - ledger.reserved(name, direction))
            r = cap / amt
            if r < total:
                total, bottleneck = r, f"{name}:{direction}"
        if not math.isfinite(total):
            raise FabricError("blend is unbounded: no use and no compute cap")
        return total, [Allocation(alt.name, w * total, bottleneck)
                       for alt, w in weighted]

    # -- the B_slow <= P − N rule --------------------------------------
    def slack(self, primary: Alternative, path: str) -> float:
        """Bandwidth left on `path` after the primary functionality
        saturates its own bottleneck. The primary's demand is clamped
        per direction (a direction it over-commits contributes zero
        slack, never a negative ledger)."""
        led = self.fabric.ledger()
        rate = primary.solo_rate(self.fabric)
        for u in primary.uses:
            led.reserve(u.path,
                        out=min(rate * u.out, led.available(u.path, OUT)),
                        in_=min(rate * u.in_, led.available(u.path, IN)),
                        flow="primary")
        return led.headroom(path)


# ----------------------------------------------------------------------
# calibrated case-study fabrics (paper §5.1)
# ----------------------------------------------------------------------

def linefs_fabric(N: float, P: float, dma_bw: Optional[float] = None) -> Fabric:
    """LineFS §5.1 testbed: network N, internal link P, weak DMA engine
    (§3.3, ~0.7 P). `internal` and `dma` share physical PCIe media."""
    dma = dma_bw if dma_bw is not None else 0.7 * P
    return Fabric.of(
        Path("net", N, BYTES_PER_S, latency=1e-6, kind="ici",
             shared_group="net"),
        Path("internal", P, BYTES_PER_S, latency=3e-7, kind="pcie",
             shared_group="pcie"),
        Path("dma", dma, BYTES_PER_S, latency=3e-7, kind="pcie",
             shared_group="pcie"),
    )


def linefs_replication_alternatives(N: float, P: float, ratio: float,
                                    soc_rate: float = math.inf,
                                    ) -> List[Alternative]:
    """File replication of 1 byte of file data (paper Figure 14).

    A1: offload via ③  — the file crosses the shared internal link twice
        (1x raw in, ratio x compressed out) and the network (ratio);
    A2: offload via ③* — DMA path, bypasses the internal link;
    A3: direct host WRITE via ① — no compression, full network bytes.
    """
    return [
        Alternative("A1", uses=[
            Use("internal", out=1.0 + ratio),     # double crossing
            Use("net", out=ratio),
        ], compute_rate=soc_rate,
            criteria={"host_cpu": 0.1, "net_utilization": 1.0}),
        Alternative("A2", uses=[
            Use("dma", out=1.0),
            Use("net", out=ratio),
        ], compute_rate=soc_rate,
            criteria={"host_cpu": 0.1, "net_utilization": 1.0}),
        Alternative("A3", uses=[
            Use("net", out=1.0),
        ], criteria={"host_cpu": 1.0, "net_utilization": ratio}),
    ]
