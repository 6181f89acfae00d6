"""Production meshes (PyTorch), the port of ``repro.launch.mesh``.

Defined as functions: importing this module touches no device and no
process group. Each builds a ``DeviceMesh`` over the default process group,
which the caller initialises first (``torch.distributed
.init_process_group`` with its world size and rank).

Single pod: (data=16, model=16)  = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; ``pod`` is the
outermost axis, ``data``/``model`` the inner ones.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the process group's ranks (tests on the CPU pass
    ``device_type="cpu"``)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
