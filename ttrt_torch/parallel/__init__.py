"""Multi-device rendering on ``torch.distributed``: the process group and
the named device mesh (``parallel.mesh``), the row-band x sample-slice
renderers (``parallel.sharding``) and the objects axis (``parallel.objects``).
Port of ``ttrt.parallel``."""
