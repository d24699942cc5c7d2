"""Launch tools of the port: the fleet mesh over a ``torch.distributed``
process group (``launch.mesh``) and the fleet's row layout and collectives
(``launch.sharding``)."""
