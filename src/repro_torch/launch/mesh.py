"""Serving and debug meshes: the counterpart of ``src/repro/launch/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` and lets GSPMD place every
array and insert the collectives.  The port has one controller process
that drives ``tp`` devices itself: a mesh is an ordered list of
``torch.device``s and a shape, the plan (``distributed/sharding.py``)
cuts each tensor into one piece a device, and the collectives
(``distributed/collectives.py``) are explicit sums, maxima and
concatenations in shard order.  Several shards may name the same device:
``devices=["cuda:0"] * 4`` serves four shards on one card and
``["cpu"] * 4`` runs them on the CPU, as the tests do.

``make_production_mesh`` is the dry run's: the JAX package's production
shapes (16 x 16, and 2 x 16 x 16 across pods) over ``meta`` devices,
which hold shapes and no data, so that a plan's specs can be read at
production size with no card.  ``force_host_device_count`` has no
counterpart: it sets an XLA flag (``--xla_force_host_platform_device_count``)
that makes virtual host devices for JAX, and the port names its devices
itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class ServingMesh:
    """A mesh of named axes over an ordered list of devices.  ``devices``
    is in row-major order over ``axis_names``; shard r of a 1-D
    ``("model",)`` mesh lives on ``devices[r]``."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        n = 1
        for s in self.sizes:
            n *= s
        if len(self.axis_names) != len(self.sizes) or n != len(self.devices):
            raise ValueError(f"mesh {self.axis_names} x {self.sizes} needs "
                             f"{n} devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def tp(self) -> int:
        return self.shape.get("model", 1)

    def model_devices(self) -> Tuple[torch.device, ...]:
        """The devices of the ``model`` axis at data index 0: shard r of a
        tensor-parallel replica lives on entry r."""
        stride = 1
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.sizes)):
            if name == "model":
                return tuple(self.devices[i * stride]
                             for i in range(size))
            stride *= size
        return self.devices[:1]


def _resolve(devices: Sequence, want: int, what: str):
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) != want:
        raise ValueError(f"{what}: {want} devices needed, {len(devs)} given")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{what}: device {d} requested but "
                               f"torch.cuda.is_available() is False")
    return devs


def _cards(n: int, what: str):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(
            f"{what}: only {have} CUDA devices visible, {n} needed — pass "
            f"devices= to place several shards on one device (e.g. "
            f"['cuda:0'] * {n}) or on the CPU")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_serving_mesh(tp: int = 1, devices: Optional[Sequence] = None
                      ) -> ServingMesh:
    """The serving node's mesh: a 1-D ``("model",)`` mesh of ``tp`` shards
    — one node = ``tp`` devices serving one model replica
    (`RealBackend(mesh=...)` shards the pools and block weights over it).
    With ``devices=None`` it takes the first ``tp`` CUDA cards and raises
    ``ValueError`` when fewer are visible; it never places shards on one
    card or on the CPU unless ``devices`` names that placement."""
    what = f"make_serving_mesh(tp={tp})"
    devs = _cards(tp, what) if devices is None \
        else _resolve(devices, tp, what)
    return ServingMesh(("model",), (tp,), devs)


def make_debug_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> ServingMesh:
    """A small ``("data", "model")`` mesh for tests; ``devices`` as in
    `make_serving_mesh` (the first data x model cards by default)."""
    what = f"make_debug_mesh(data={data}, model={model})"
    n = data * model
    devs = _cards(n, what) if devices is None else _resolve(devices, n, what)
    return ServingMesh(("data", "model"), (data, model), devs)


def make_production_mesh(*, multi_pod: bool = False) -> ServingMesh:
    """The production mesh of the dry run, over ``meta`` devices:
    ``("data", "model")`` (16, 16) for one pod, ``("pod", "data",
    "model")`` (2, 16, 16) across two: ``model`` is a replica's 16-way
    tensor parallelism, ``data`` the replicas of a pod."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in sizes:
        n *= s
    return ServingMesh(axes, sizes, (torch.device("meta"),) * n)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mp_axis(mesh) -> str:
    return "model"
