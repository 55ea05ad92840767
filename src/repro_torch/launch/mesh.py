"""Device meshes for the streaming engine (``repro.launch.mesh``).

A ``Mesh`` is named axes over a list of ``torch.device``s, one per shard in
row-major order, driven by one engine object in one process: the
counterpart of the reference's ``jax.sharding.Mesh``, whose one engine
drives every device through ``jit``/``shard_map``. The sharded plans
(``repro_torch.core.distributed``) keep a list of per-shard states, each on
its shard's device, and run their collectives (all_to_all, all_gather,
psum) as copies between those shards in axis-index order: tensor copies
where shards share a device, peer copies across GPUs.

Where the shards live: without ``host_devices`` a mesh of n shards takes n
devices of the kind ``device`` names (``cuda:0`` .. ``cuda:n-1``) and raises,
naming the flag, where the machine has fewer; ``host_devices=N`` (the CLI's
``--host-devices N``) puts all N shards on the one device ``device`` names,
the CPU in tests or ``cuda:0`` on one card, as the reference's flag forces N
CPU host devices (``repro/launch/_env.py``). A mesh of M shards takes the
first M of them, and M above N raises the reference's error. No shard moves
to the CPU unless the caller asked for the CPU. The dry run's
``make_production_mesh`` alone puts its shards on ``meta``.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from repro_torch import resolve_device

DeviceLike = Union[str, torch.device]


class Mesh:
    """Named axes over one device per shard (row-major)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ")
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} devices, "
                             f"got {len(devices)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def coords(self, shard: int) -> dict:
        """The shard's index along every axis."""
        out = {}
        for name in reversed(self.axis_names):
            shard, out[name] = divmod(shard, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, shard: int, axes: Sequence[str]) -> int:
        """The shard's row-major index over ``axes`` (taken in mesh order),
        ``jax.lax.axis_index(axes)``; 0 for no axes."""
        c = self.coords(shard)
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + c[a]
        return idx

    def groups(self, axes: Sequence[str]) -> list[list[int]]:
        """The collective groups over ``axes``: the shards that differ only
        along them, each group in ``axis_index(axes)`` order, the groups in
        the row-major order of the remaining axes."""
        rest = [a for a in self.axis_names if a not in axes]
        out: dict[int, list[int]] = {}
        for shard in range(self.size):
            out.setdefault(self.axis_index(shard, rest), []).append(shard)
        return [sorted(g, key=lambda i: self.axis_index(i, axes)) for _, g in sorted(out.items())]


def _parse(spec: str) -> tuple[list[str], list[int]]:
    names, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if "=" in part:
            name, _, size = part.partition("=")
        else:
            name, size = "estimators", part
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad --mesh entry {part!r}; want N or axis=N "
                             "(e.g. 'tenants=2,estimators=4')") from None
        if n < 1 or name.strip() in names:
            raise ValueError(f"bad --mesh spec {spec!r}")
        names.append(name.strip())
        sizes.append(n)
    return names, sizes


def mesh_devices(n: int, shape: Sequence[int], device: DeviceLike = "cuda",
                 host_devices: int = 0) -> list[torch.device]:
    """The n devices of a mesh of ``shape`` (module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if host_devices and host_devices > 0:
        if host_devices < n:
            raise ValueError(f"Number of devices {host_devices} must be >= the product of "
                             f"mesh_shape {tuple(shape)}")
        return [dev] * n
    if dev.type == "cpu":
        have = 1
    else:
        have = torch.cuda.device_count() - dev.index
    if have < n:
        raise ValueError(
            f"a mesh of {n} shards needs {n} {dev.type} devices, this machine has {have}; "
            f"pass --host-devices {n} (host_devices={n}) to put every shard on {dev}")
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", dev.index + i) for i in range(n)]


def make_stream_mesh(spec: str, device: DeviceLike = "cuda", host_devices: int = 0):
    """Mesh for the streaming engine from a CLI ``--mesh`` spec, in the
    reference's grammar (axes in the order written):

      ""                        -> None (no mesh; the engine runs ``single``)
      "8"                       -> 8-way estimator sharding, axes ("estimators",)
      "tenants=2"               -> pure tenant sharding over 2 shards
      "tenants=2,estimators=4"  -> the 2-D banked layout over 8 shards

    The axis named ``EngineConfig.tenant_axis`` (default "tenants") carries
    the bank's tenant dimension; every other axis shards the estimators."""
    spec = spec.strip()
    if not spec:
        return None
    names, sizes = _parse(spec)
    return Mesh(sizes, names, mesh_devices(math.prod(sizes), sizes, device, host_devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's mesh: 16 x 16 = 256 shards as ("data", "model"), or
    with ``multi_pod`` 2 x 16 x 16 = 512 as ("pod", "data", "model"), every
    shard on the ``meta`` device, so a step or a plan over it runs on
    shapes only and allocates nothing (``launch/dryrun.py``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, [torch.device("meta")] * math.prod(shape))


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device: DeviceLike = "cpu",
                   host_devices: int = 8):
    """A small mesh for tests: every shard on ``device`` (the CPU), as the
    reference's test mesh spans 8 forced host devices."""
    return Mesh(shape, axes, mesh_devices(math.prod(shape), shape, device, host_devices))


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)
