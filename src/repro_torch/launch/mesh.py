"""Device meshes of the port: ``torch.distributed.device_mesh`` over an
H100 cluster.

Single pod: (32, 8) over ("data", "model"), 256 GPUs.  Multi-pod:
(2, 32, 8) over ("pod", "data", "model"), 512 GPUs; the ``pod`` axis is
pure data parallelism (serving replicas, gradient all-reduce), so pods come
and go without resharding the model axes.

The model axis is 8, not the reference's 16 (a v5e pod's 16 x 16 torus):
an H100 node holds 8 GPUs joined all to all by NVLink (450 GB/s per
direction each), and nodes talk over InfiniBand (about 50 GB/s per GPU).
Tensor parallelism reduces activations in every layer, so it stays inside
a node; a model axis of 16 would put half of each reduction on
InfiniBand.  The data axis spans the 32 nodes of a pod.

Each constructor is a function, so importing this module touches no
process group: the caller has initialised ``torch.distributed`` (a real
backend, or the fake one of the dry run) with a world of the mesh's size.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.device_mesh import init_device_mesh

POD_SHAPE = (32, 8)
AXES = ("data", "model")


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The H100 cluster's mesh: (32, 8) or, multi-pod, (2, 32, 8)."""
    shape = ((2,) + POD_SHAPE) if multi_pod else POD_SHAPE
    axes = (("pod",) + AXES) if multi_pod else AXES
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(data: int = 2, model: int = 2, *, device_type=None):
    """A small ("data", "model") mesh; (4, 2) is the reference's test mesh
    of 8 devices."""
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=AXES)


@contextlib.contextmanager
def mesh_context(mesh):
    """Scope the mesh for the enclosed calls (the reference's
    ``jax.set_mesh``): yields the mesh; DTensors carry their own mesh, so
    nothing else is set."""
    yield mesh
