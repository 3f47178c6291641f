"""Device meshes on one host.

Counterpart of ``cpgisland_tpu/parallel/mesh.py`` without
``initialize_multihost`` (the multi-host half, ROADMAP A9).  The JAX
package's ``shard_map`` programs run on a single controller over one
host's devices; the port does the same: one process drives a
:class:`Mesh`, an array of ``torch.device`` entries with axis names, and
every sharded function runs its per-shard work on each entry's device in
mesh order.  The collectives exchange tensors of [K] and [K, K] per shard
(and the [K, K] + [K, S] + [K] statistics): they gather onto the mesh's
first device, compute there, and send the results back.

A mesh may name one device more than once: a mesh of 8 entries that all
name ``cpu`` is the counterpart of the JAX tests' 8 virtual CPU devices,
and a mesh of 4 entries on ``cuda:0`` drives the sharded algorithms on
one card.  A 1-D ``data`` axis carries chunk-parallel training; ``seq``
names the axis of sequence-parallel decoding, posterior and E-steps.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def _norm_device(d) -> torch.device:
    """A concrete ``torch.device``: a bare "cuda" names the current card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev


class Mesh:
    """An array of devices with one name per axis (the shape of
    ``jax.sharding.Mesh`` that the port uses): ``devices`` (an object
    array of ``torch.device``), ``axis_names`` and ``shape`` (axis name
    -> size, in axis order)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            arr.flat[i] = _norm_device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                             f"got {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The entries in mesh (row-major) order."""
        return list(self.devices.reshape(-1))

    @property
    def first(self) -> torch.device:
        """The device the collectives gather onto."""
        return self.devices.reshape(-1)[0]

    def _key(self):
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.device_list))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.device_list]})")


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` as a port :class:`Mesh` (None stays None).  A JAX mesh is
    refused: the port never drives JAX devices."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    raise TypeError(
        f"expected a cpgisland_tpu_torch.parallel.mesh.Mesh, got {type(mesh).__module__}."
        f"{type(mesh).__name__}; build the port's mesh with parallel.mesh.make_mesh"
    )


def local_device_count(device="cuda") -> int:
    """Devices of ``device``'s kind on this host: the cards for "cuda",
    one for a named card or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return 1


def _local_devices(device, n_devices: Optional[int]) -> list:
    """The first ``n_devices`` devices of ``device``'s kind (default: all
    of them): every card for "cuda", exactly one for "cuda:N", and for
    the CPU ``n_devices`` entries naming it (default one)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else int(n_devices))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    if dev.index is not None:
        if n_devices not in (None, 1):
            raise ValueError(f"{device} names one card; requested {n_devices} devices")
        return [dev]
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have or n < 1:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device="cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of ``device``'s
    kind (default: all; see :func:`_local_devices`)."""
    return Mesh(_local_devices(device, n_devices), (axis,))


def make_mesh2d(dp: int, sp: Optional[int] = None,
                axes: Sequence[str] = (DATA_AXIS, SEQ_AXIS), device="cuda",
                n_devices: Optional[int] = None) -> Mesh:
    """A 2-D (data x seq) mesh: sequences over ``dp`` rows, time over
    ``sp`` columns, from the devices :func:`make_mesh` would take."""
    devs = _local_devices(device, n_devices)
    if sp is None:
        if len(devs) % dp != 0:
            raise ValueError(f"{len(devs)} devices not divisible by dp={dp}")
        sp = len(devs) // dp
    if dp * sp > len(devs):
        raise ValueError(f"requested {dp}x{sp} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[: dp * sp], dtype=object).reshape(dp, sp), tuple(axes))


def auto_mesh2d(n_sequences: int, axes: Sequence[str] = (DATA_AXIS, SEQ_AXIS),
                device="cuda", n_devices: Optional[int] = None) -> Mesh:
    """A balanced dp x sp split of the devices for ``n_sequences``: dp is
    the largest divisor of the device count not exceeding the sequence
    count, so no data row idles; the other devices go to sequence
    parallelism (8 devices, 3 chromosomes -> 2 x 4)."""
    n = len(_local_devices(device, n_devices))
    dp = max(d for d in range(1, n + 1) if n % d == 0 and d <= max(1, n_sequences))
    return make_mesh2d(dp, n // dp, axes=axes, device=device, n_devices=n_devices)


def fetch_sharded_prefix(shards, T: int, return_device: bool):
    """The first ``T`` positions of a per-position output split over a
    mesh's shards (a list of tensors in mesh order), joined on the first
    shard's device (``return_device``) or on the host."""
    if len(shards) == 1:
        x = shards[0][:T]
        return x if return_device else x.cpu().numpy()
    if return_device:
        dev = shards[0].device
        return torch.cat([s.to(dev, non_blocking=True) for s in shards])[:T]
    return np.concatenate([s.cpu().numpy() for s in shards])[:T]
