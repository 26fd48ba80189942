"""Sharding rules and activation hooks over ``torch.distributed`` device
meshes (``sharding.py``)."""
