"""Provider Proxy (paper §3.1): collects user + provider interface info and
validates credentials/capabilities before Hydra's engine starts.

A *provider* on the GPU-fleet adaptation is a named device pool: a slice of
the visible CUDA devices (or the CPU, for a broker built with
``device="cpu"``) with a platform type (cloud-like on-demand pool
vs HPC-like batch pool), a capability vector, and a connector kind.  The
proxy checks that (1) the credential record is well-formed, (2) the pool's
devices are actually visible to the runtime, (3) pools do not overlap, and
(4) the declared capabilities are consistent - the same role the paper's
Provider Proxy plays for AWS/Azure/Jetstream2/Chameleon credentials.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from repro_torch.core.task import Resources
from repro_torch.runtime.tracing import Trace


class CredentialError(RuntimeError):
    pass


class ValidationError(RuntimeError, ValueError):
    """Bad configuration value.  Subclasses ValueError too: callers that
    guard spec construction with ``except ValueError`` (the stdlib contract
    for rejected arguments, e.g. LaunchSpec bounds) catch these, while the
    historical ``except RuntimeError`` handlers keep working."""


@dataclass
class ProviderSpec:
    """Static description of one provider (device pool)."""

    name: str
    platform: str = "cloud"  # "cloud" | "hpc"
    connector: str = "caas"  # "caas" | "pilot"
    n_devices: int = 1
    device_offset: int = 0  # slice [offset, offset+n) of the broker's devices
    node_capacity: Resources = field(default_factory=lambda: Resources(cpus=16, accels=8, memory_mb=1 << 16))
    n_nodes: int = 1
    concurrency: int = 4  # concurrent task slots
    submit_latency_s: float = 0.0  # modeled provider API round-trip
    env_setup_s: float = 0.0  # modeled pod env bring-up (container pull etc.)
    queue_delay_s: float = 0.0  # modeled HPC batch queue wait
    credentials: dict = field(default_factory=lambda: {"token": "local"})

    def capacity(self) -> Resources:
        return Resources(
            cpus=self.node_capacity.cpus * self.n_nodes,
            accels=self.node_capacity.accels * self.n_nodes,
            memory_mb=self.node_capacity.memory_mb * self.n_nodes,
        )


@dataclass
class ProviderHandle:
    """A validated provider: spec + live device slice + health state.

    ``group`` names the ProviderGroup the provider is pooled into, if any;
    grouped providers are reached through their group's logical name and are
    excluded from direct policy binding (their health lives in the group's
    per-member circuit breaker, see core/group.py)."""

    spec: ProviderSpec
    devices: list = field(default_factory=list)
    healthy: bool = True
    group: Optional[str] = None
    # tasks dispatched to this (ungrouped) provider and not yet finished:
    # maintained by the broker, feeds the load-aware idle_slots() hint.
    # Grouped members track load in their GroupMember instead.  Guarded by
    # its own per-handle lock: this counter moves twice per task (dispatch
    # and completion, from hundreds of manager threads), and serializing it
    # through the broker-wide lock was a measurable §Perf hot spot.
    outstanding: int = 0
    load_lock: threading.Lock = field(default_factory=threading.Lock)
    trace: Trace = field(default_factory=Trace)

    @property
    def name(self) -> str:
        return self.spec.name


def resolve_device(device) -> torch.device:
    """The broker's device kind: ``"cuda"`` (the default everywhere) or
    ``"cpu"``.  A CUDA broker on a machine without a CUDA device raises here:
    it never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValidationError(f"unsupported broker device {device!r}: expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Hydra(device='cuda') needs a CUDA device and none is visible; "
            "pass device='cpu' to run the kernels' plain versions on the CPU"
        )
    return dev


class ProviderProxy:
    """Registry + validation of providers and provider groups (the paper's
    Provider Proxy, extended with the group layer).  ``device`` is the kind of
    device every provider's pool is cut from (see resolve_device)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._providers: dict[str, ProviderHandle] = {}
        self._groups: dict[str, Any] = {}  # name -> ProviderGroup
        self._lock = threading.Lock()
        # topology version: bumped on every change that can alter the
        # bind-target set or its capacities (register/deregister, group
        # membership, health flips, breaker transitions).  Keys the cached
        # bind_targets() list and the policies' eligibility index
        # (core/policy.py), making the per-dispatch "what can I bind to"
        # question O(1) on an unchanged topology.
        self._version = 0
        self._targets_cache: Optional[tuple[int, list]] = None

    def bump_version(self) -> None:
        """Invalidate the cached bind-target list (health flips and breaker
        transitions live outside the proxy, so their owners call this)."""
        with self._lock:
            self._bump()

    def _bump(self) -> None:
        # callers hold self._lock
        self._version += 1
        self._targets_cache = None

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def register(self, spec: ProviderSpec) -> ProviderHandle:
        self._validate_credentials(spec)
        devices = self._validate_devices(spec)
        with self._lock:
            if spec.name in self._providers or spec.name in self._groups:
                raise ValidationError(f"provider {spec.name!r} already registered")
            handle = ProviderHandle(spec=spec, devices=devices)
            handle.trace.add("validated")
            self._providers[spec.name] = handle
            self._bump()
            return handle

    def deregister(self, name: str) -> ProviderHandle:
        with self._lock:
            handle = self._providers.pop(name)
            self._bump()
            return handle

    def get(self, name: str) -> ProviderHandle:
        h = self._providers.get(name)
        if h is None:
            raise KeyError(f"unknown provider {name!r}")
        return h

    def healthy(self) -> list[ProviderHandle]:
        with self._lock:
            return [h for h in self._providers.values() if h.healthy]

    def all(self) -> list[ProviderHandle]:
        with self._lock:
            return list(self._providers.values())

    # -- groups --------------------------------------------------------
    def register_group(self, group) -> None:
        """Register a ProviderGroup; its name becomes a logical bind target
        and its members leave the direct-binding pool."""
        with self._lock:
            if group.name in self._providers or group.name in self._groups:
                raise ValidationError(f"name {group.name!r} already registered")
            for member in group.member_names:
                h = self._providers.get(member)
                if h is None:
                    raise ValidationError(
                        f"group {group.name!r}: member {member!r} is not a registered provider"
                    )
                if h.group is not None:
                    raise ValidationError(
                        f"group {group.name!r}: member {member!r} already in group {h.group!r}"
                    )
            for member in group.member_names:
                self._providers[member].group = group.name
            self._groups[group.name] = group
            self._bump()

    def attach_member(self, group_name: str, member_name: str) -> ProviderHandle:
        """Wire an already-registered provider into a live group (elastic
        scale-out: the group side is ProviderGroup.add_member).  The member
        leaves the direct-binding pool, exactly as at group registration."""
        with self._lock:
            if group_name not in self._groups:
                raise KeyError(f"unknown provider group {group_name!r}")
            h = self._providers.get(member_name)
            if h is None:
                raise ValidationError(
                    f"group {group_name!r}: member {member_name!r} is not a registered provider"
                )
            if h.group is not None:
                raise ValidationError(
                    f"group {group_name!r}: member {member_name!r} already in group {h.group!r}"
                )
            h.group = group_name
            self._bump()
            return h

    def get_group(self, name: str):
        g = self._groups.get(name)
        if g is None:
            raise KeyError(f"unknown provider group {name!r}")
        return g

    def is_group(self, name: str) -> bool:
        return name in self._groups

    def groups(self) -> list:
        with self._lock:
            return list(self._groups.values())

    def bind_targets(self) -> list:
        """What binding policies may choose from: healthy *ungrouped*
        providers plus routable groups (grouped members are reached only
        through their group).

        The list is CACHED per topology version and the cached object is
        returned directly (callers treat it as read-only), so the dispatch
        hot path pays O(1) instead of an O(providers) rebuild per batch —
        and its identity keys the policies' eligibility index.  The cache
        is skipped while any group is excluded for routability: a
        non-routable group can become routable again purely by TIME (its
        members' breaker reset windows elapsing), which no event signals.

        Group routability is evaluated OUTSIDE the proxy lock: a member
        breaker transition (under group/breaker locks) re-enters the proxy
        via bump_version, so peeking group state under the proxy lock would
        close a proxy -> group -> proxy lock cycle."""
        with self._lock:
            cached = self._targets_cache
            if cached is not None and cached[0] == self._version:
                return cached[1]
            ver = self._version
            targets: list = [
                h for h in self._providers.values() if h.healthy and h.group is None
            ]
            groups = list(self._groups.values())
        excluded = False
        for g in groups:
            if g.routable():
                targets.append(g)
            else:
                excluded = True
        with self._lock:
            if not excluded and self._version == ver:
                self._targets_cache = (ver, targets)
        return targets

    def targets_version(self, targets) -> Optional[int]:
        """The topology version ``targets`` was built at — iff it IS the
        proxy's current cached bind-target list (identity check).  Any other
        list (filtered rebind/speculation lists, test fixtures) returns None
        and eligibility falls back to a scan."""
        with self._lock:
            cached = self._targets_cache
            if cached is not None and cached[1] is targets and cached[0] == self._version:
                return cached[0]
            return None

    # ------------------------------------------------------------------
    @staticmethod
    def _validate_credentials(spec: ProviderSpec) -> None:
        creds = spec.credentials
        if not isinstance(creds, dict) or "token" not in creds or not creds["token"]:
            raise CredentialError(f"provider {spec.name!r}: missing or empty credential token")
        if spec.platform not in ("cloud", "hpc"):
            raise ValidationError(f"provider {spec.name!r}: unknown platform {spec.platform!r}")
        if spec.connector not in ("caas", "pilot"):
            raise ValidationError(f"provider {spec.name!r}: unknown connector {spec.connector!r}")

    def _validate_devices(self, spec: ProviderSpec) -> list:
        if self.device.type == "cpu":
            devs = [torch.device("cpu")]
        else:
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        lo, hi = spec.device_offset, spec.device_offset + spec.n_devices
        if spec.n_devices < 1:
            raise ValidationError(f"provider {spec.name!r}: n_devices must be >= 1")
        if hi > len(devs):
            # device pools may logically share a device (the one CPU, or a
            # one-card machine); only reject if the pool is empty
            if spec.device_offset >= len(devs):
                slice_ = [devs[spec.device_offset % len(devs)]]
            else:
                slice_ = devs[lo:]
        else:
            slice_ = devs[lo:hi]
        return list(slice_)
